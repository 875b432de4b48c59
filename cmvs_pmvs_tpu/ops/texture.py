"""Batched patch texture grabbing and NCC scoring.

Batched port of the reference hot loop (SURVEY.md section 3.4): for a
batch of patches and up to tau views each, project the patch tangent frame,
pick a pyramid level from the projected footprint, gather a wsize x wsize
bilinear window, normalize to zero-mean/unit-variance and correlate
(reference source/pmvs/optim.cpp:783-863 grabTex, :1031-1067 normalize,
:1069-1088 dot).

Everything is expressed over [B, T] batches with validity masks instead of
per-patch early-outs; failed grabs produce valid=False, which downstream
score aggregation maps to the reference's empty-texture semantics.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..geom.cameras import HIGHEST, CameraSet, project
from ..image.pyramid import PyramidSet
from ..image.sample import bicubic_color, bilinear_color

# Subpixel sampling mode: "bilinear" (reference default) or "bicubic"
# (the reference's compile-time FURUKAWA_IMAGE_BICUBIC variant,
# image.hpp:282-433).
SAMPLING = "bilinear"


def robustincc(x):
    """x / (1 + 3x) (reference include/pmvs/optim.hpp:86-88)."""
    return x / (1.0 + 3.0 * x)


def unrobustincc(x):
    """Inverse: x / (1 - 3x) (reference optim.hpp:90-92)."""
    return x / (1.0 - 3.0 * x)


def _grab_frame(cams: CameraSet, pyr: PyramidSet, level: int, wsize: int,
                coord, pxaxis, pyaxis, pzaxis, views, view_valid,
                angle_threshold):
    """Shared geometry of grabTex: projected frame, adaptive level,
    grabSafe gate. Returns (c2, dx2, dy2, newlevel, vid, ok)."""
    b, t = views.shape
    vid = jnp.maximum(views, 0)
    margin = wsize // 2

    # angle gate: ray to optical center vs patch normal (optim.cpp:818-823)
    ray = cams.center[vid] - coord[:, None, :]               # [B, T, 4]
    ray = ray / jnp.linalg.norm(ray[..., :3], axis=-1, keepdims=True)
    weight = jnp.einsum("btk,bk->bt", ray[..., :3], pzaxis[:, :3],
                        precision=HIGHEST)
    ok = view_valid & (weight >= jnp.cos(angle_threshold))

    # project the frame (optim.cpp:827-829)
    P = cams.P[vid]                                          # [B, T, 3, 4]
    center2 = project(P, coord[:, None, :], level)
    dx = project(P, (coord + pxaxis)[:, None, :], level) - center2
    dy = project(P, (coord + pyaxis)[:, None, :], level) - center2

    # footprint level selection (optim.cpp:831-843)
    ratio = (jnp.linalg.norm(dx[..., :2], axis=-1)
             + jnp.linalg.norm(dy[..., :2], axis=-1)) / 2.0
    safe_ratio = jnp.where(ratio > 0.0, ratio, 1.0)
    leveldif = jnp.floor(jnp.log2(safe_ratio) + 0.5).astype(jnp.int32)
    leveldif = jnp.clip(leveldif, -level, 2)
    newlevel = level + leveldif
    # also stay within the allocated pyramid (reference allocates level+3)
    newlevel = jnp.clip(newlevel, 0, pyr.num_levels - 1)
    scale = (2.0 ** (newlevel - level)).astype(center2.dtype)[..., None]

    c2 = center2[..., :2] / scale
    dx2 = dx[..., :2] / scale
    dy2 = dy[..., :2] / scale

    # grabSafe margin check (optim.cpp:783-805, margin2 = 3)
    span = (jnp.abs(dx2) + jnp.abs(dy2)) * margin
    minxy = c2 - span
    maxxy = c2 + span
    w = pyr.widths[newlevel, vid].astype(c2.dtype)
    h = pyr.heights[newlevel, vid].astype(c2.dtype)
    margin2 = 3.0
    safe = ((minxy[..., 0] >= margin2) & (minxy[..., 1] >= margin2)
            & (maxxy[..., 0] < w - 1 - margin2)
            & (maxxy[..., 1] < h - 1 - margin2))
    ok = ok & safe
    return c2, dx2, dy2, newlevel, vid, ok


def _sample_positions(c2, dx2, dy2, ok, wsize: int):
    """[B, T, S2, 2] level-space sample positions (optim.cpp:846-862)."""
    margin = wsize // 2
    offs = jnp.arange(wsize, dtype=c2.dtype) - margin
    gy, gx = jnp.meshgrid(offs, offs, indexing="ij")
    gx = gx.reshape(-1)   # [S2]
    gy = gy.reshape(-1)
    pos = (c2[:, :, None, :]
           + gx[None, None, :, None] * dx2[:, :, None, :]
           + gy[None, None, :, None] * dy2[:, :, None, :])
    # clamp positions for invalid pairs so gathers stay in range
    return jnp.where(ok[..., None, None], pos, 3.0)


def grab_tex(cams: CameraSet, pyr: PyramidSet, level: int, wsize: int,
             coord, pxaxis, pyaxis, pzaxis, views, view_valid,
             angle_threshold: float = jnp.pi / 3.0):
    """Grab wsize^2 RGB windows for a [B, T] batch of (patch, view) pairs.

    coord/pxaxis/pyaxis/pzaxis: [B, 4]; views: [B, T] int32 (clamped >= 0
    for gathers); view_valid: [B, T] bool.

    Returns (texs [B, T, wsize*wsize, 3] float, valid [B, T] bool).
    Matches reference COptim::grabTex (optim.cpp:815-863): view-angle gate,
    footprint-adaptive pyramid level (leveldif in [-level, 2],
    optim.cpp:831-843), grabSafe margin-3 boundary check (optim.cpp:783-805).
    """
    c2, dx2, dy2, newlevel, vid, ok = _grab_frame(
        cams, pyr, level, wsize, coord, pxaxis, pyaxis, pzaxis, views,
        view_valid, angle_threshold)
    pos = _sample_positions(c2, dx2, dy2, ok, wsize)

    # one 4-tap (16-tap bicubic) gather per sample straight from the
    # atlas; on an H100 this runs ~10x faster than extracting a 20x20x3
    # block per pair and contracting hat weights (PERF.md)
    nl = jnp.broadcast_to(newlevel[..., None], pos.shape[:-1])
    nv = jnp.broadcast_to(vid[..., None], pos.shape[:-1])
    sample = bicubic_color if SAMPLING == "bicubic" else bilinear_color
    return sample(pyr, nv, nl, pos[..., 0], pos[..., 1]), ok


def normalize_tex(texs, valid):
    """Zero per-channel mean, unit global variance per (patch, view)
    (reference optim.cpp:1031-1067)."""
    s2 = texs.shape[-2]
    mean = texs.mean(axis=-2, keepdims=True)            # per-channel
    dev = texs - mean
    var = (dev * dev).sum(axis=(-2, -1)) / (3.0 * s2)
    std = jnp.sqrt(var)
    std = jnp.where(std == 0.0, 1.0, std)
    out = dev / std[..., None, None]
    return jnp.where(valid[..., None, None], out, 0.0)


def ncc_dot(tex0, tex1):
    """Mean of elementwise products over the 3*S2 values
    (reference optim.cpp:1069-1077). tex*: [..., S2, 3]."""
    s2 = tex0.shape[-2]
    return (tex0 * tex1).sum(axis=(-2, -1)) / (3.0 * s2)
