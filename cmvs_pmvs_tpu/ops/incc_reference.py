"""Plain float64 numpy reference of the refine objective's evaluator.

An independent re-statement of `ops/refine.per_view_inccs` (reference
my_f's reference-based branch, optim.cpp:556-575, over grabTex
optim.cpp:815-863, normalize :1031-1067 and dot :1069-1088) for
checking the device evaluator: the same atlas and cameras in, robust
INCCs of every (patch, view) pair out, computed on the host in float64
with no JAX.

Pairs whose gates sit at a threshold (the view-angle test, the
footprint level rounding, the grabSafe margin) may legitimately flip
between float32 and float64; `decided` marks the pairs that are clear
of every threshold, and a comparison should be made on those.
"""
from __future__ import annotations

import math

import numpy as np

_SENTINEL = -65535.0


def _project(P, X, level: int):
    """P [..., 3, 4], X [..., 4] -> [..., 3] (camera.hpp:89-108)."""
    Pl = P.copy()
    Pl[..., :2, :] /= 2.0 ** level
    v = np.einsum("...ij,...j->...i", Pl, X)
    z = v[..., 2:3]
    bad = z <= 0.0
    out = np.clip(v / np.where(bad, 1.0, z), -1e9, 1e9)
    sent = np.broadcast_to(np.array([_SENTINEL, _SENTINEL, -1.0]),
                           out.shape)
    return np.where(bad, sent, out)


def per_view_inccs(P, atlas, widths, heights, xoff, level: int, wsize: int,
                   coord, normal, views, view_valid,
                   angle_threshold: float = math.pi / 3.0):
    """Returns (incc [B, T] with 2.0 at invalid pairs, ref_ok [B],
    pair_ok [B, T], decided [B, T]).

    P: [N, 3, 4]; atlas: [N, H, WA, 3] mip atlas (image/pyramid.py);
    widths/heights: [L, N]; xoff: [L]; coord/normal: [B, 4];
    views: [B, T] (slot 0 = reference); view_valid: [B, T].
    """
    P = np.asarray(P, np.float64).reshape(-1, 3, 4)
    atlas = np.asarray(atlas, np.float64)
    widths, heights = np.asarray(widths), np.asarray(heights)
    xoff = np.asarray(xoff)
    coord = np.asarray(coord, np.float64)
    normal = np.asarray(normal, np.float64)
    views = np.asarray(views)
    view_valid = np.asarray(view_valid, bool)
    num_levels = len(xoff)
    b, t = views.shape

    # camera frame (camera.cpp:109-136, optim.cpp:55-63)
    oz = P[:, 2, :3] / np.linalg.norm(P[:, 2, :3], axis=1, keepdims=True)
    centers = np.stack([np.linalg.solve(p[:, :3], -p[:, 3]) for p in P])
    yax = np.cross(oz, P[:, 0, :3])
    yax /= np.linalg.norm(yax, axis=1, keepdims=True)
    xax = np.cross(yax, oz)
    ipscale = (np.einsum("nk,nk->n", xax, P[:, 0, :3])
               + np.einsum("nk,nk->n", yax, P[:, 1, :3]))

    # getPAxes against the reference view (optim.cpp:1127-1144)
    ref = np.maximum(views[:, 0], 0)
    pscale = (2.0 * np.linalg.norm(coord[:, :3] - centers[ref], axis=1)
              * 2.0 ** level / ipscale[ref])
    n3 = normal[:, :3]
    y3 = np.cross(n3, xax[ref])
    y3 /= np.linalg.norm(y3, axis=1, keepdims=True)
    x3 = np.cross(y3, n3)
    zero = np.zeros((b, 1))
    axes = []
    pc = _project(P[ref], coord, level)
    for a3 in (x3, y3):
        ax = np.concatenate([a3, zero], 1) * pscale[:, None]
        dis = np.linalg.norm((_project(P[ref], coord + ax, level)
                              - pc)[:, :2], axis=1)
        axes.append(ax / np.where(dis == 0.0, 1.0, dis)[:, None])
    px, py = axes

    # grabTex frame, level and gates (optim.cpp:815-843, 783-805)
    vid = np.maximum(views, 0)
    ray = centers[vid] - coord[:, None, :3]
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    weight = np.einsum("btk,bk->bt", ray, n3)
    cos_thr = math.cos(angle_threshold)
    ok = view_valid & (weight >= cos_thr)
    decided = np.abs(weight - cos_thr) > 1e-5
    Pv = P[vid]
    c2 = _project(Pv, coord[:, None], level)
    dx = _project(Pv, (coord + px)[:, None], level) - c2
    dy = _project(Pv, (coord + py)[:, None], level) - c2
    ratio = (np.linalg.norm(dx[..., :2], axis=-1)
             + np.linalg.norm(dy[..., :2], axis=-1)) / 2.0
    lg = np.log2(np.where(ratio > 0.0, ratio, 1.0)) + 0.5
    decided &= np.abs(lg - np.round(lg)) > 1e-4
    newlevel = np.clip(level + np.clip(np.floor(lg).astype(np.int64),
                                       -level, 2), 0, num_levels - 1)
    scale = (2.0 ** (newlevel - level))[..., None]
    c2, dx2, dy2 = c2[..., :2] / scale, dx[..., :2] / scale, \
        dy[..., :2] / scale
    margin = wsize // 2
    span = (np.abs(dx2) + np.abs(dy2)) * margin
    lo, hi = c2 - span, c2 + span
    w = widths[newlevel, vid].astype(np.float64)
    h = heights[newlevel, vid].astype(np.float64)
    edges = np.stack([lo[..., 0] - 3.0, lo[..., 1] - 3.0,
                      w - 4.0 - hi[..., 0], h - 4.0 - hi[..., 1]], -1)
    ok &= np.all(edges[..., :2] >= 0.0, axis=-1) \
        & np.all(edges[..., 2:] > 0.0, axis=-1)
    decided &= np.all(np.abs(edges) > 1e-3, axis=-1)

    # bilinear samples of the wsize^2 lattice (image.hpp:434-471)
    offs = np.arange(wsize) - margin
    gy, gx = np.meshgrid(offs, offs, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    pos = (c2[:, :, None, :] + gx[:, None] * dx2[:, :, None, :]
           + gy[:, None] * dy2[:, :, None, :])
    pos = np.where(ok[..., None, None], pos, 3.0)
    lx = np.floor(pos[..., 0]).astype(np.int64)
    ly = np.floor(pos[..., 1]).astype(np.int64)
    fx = (pos[..., 0] - lx)[..., None]
    fy = (pos[..., 1] - ly)[..., None]
    ax0 = lx + xoff[newlevel][..., None]
    n_idx = vid[..., None]
    hh, wa = atlas.shape[1], atlas.shape[2]

    def px_at(xi, yi):
        return atlas[n_idx, np.clip(yi, 0, hh - 1), np.clip(xi, 0, wa - 1)]

    tex = (px_at(ax0, ly) * (1 - fx) * (1 - fy)
           + px_at(ax0 + 1, ly) * fx * (1 - fy)
           + px_at(ax0, ly + 1) * (1 - fx) * fy
           + px_at(ax0 + 1, ly + 1) * fx * fy)             # [B, T, S2, 3]

    # normalize and correlate with the reference window
    s2 = wsize * wsize
    dev = tex - tex.mean(axis=2, keepdims=True)
    std = np.sqrt((dev * dev).sum(axis=(2, 3)) / (3.0 * s2))
    tex = dev / np.where(std == 0.0, 1.0, std)[..., None, None]
    tex = np.where(ok[..., None, None], tex, 0.0)
    dots = (tex[:, :1] * tex).sum(axis=(2, 3)) / (3.0 * s2)
    x = 1.0 - dots
    incc = x / (1.0 + 3.0 * x)
    ref_ok = ok[:, 0]
    pair_ok = ok & ref_ok[:, None]
    pair_ok[:, 0] = False
    decided &= decided[:, :1]
    return np.where(pair_ok, incc, 2.0), ref_ok, pair_ok, decided
