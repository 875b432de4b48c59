"""View-set selection for patches: the preProcess/postProcess machinery.

Batched port of COptim's image-set management (reference
source/pmvs/optim.cpp): during processing a patch's view set is a dense
boolean mask [B, N] plus a reference index [B], rather than an ordered
vector - order is recreated where it matters (slot 0 = reference; the
greedy sortImages ordering materializes the first-tau views used by
optimization).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geom.cameras import HIGHEST, CameraSet, get_unit, project
from ..image.pyramid import PyramidSet
from ..image.sample import edge_at
from ..ops.refine import RefineProblem, per_view_inccs, _patch_axes
from ..ops.texture import grab_tex, ncc_dot, normalize_tex, robustincc

HUGE = 1.0e10


def collect_images_all(cams: CameraSet, visdata: jnp.ndarray,
                       distances: jnp.ndarray, tau: int,
                       sequence: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per reference image, the tau best related views
    (reference optim.cpp:66-93 collectImages): visdata neighbors, within
    the sequence window, optical axes within 60 deg, sorted by
    CPhotoSetS::_distances.

    visdata: [N, N] bool; distances: [N, N]. Returns
    (views [N, tau] int32 with -1 padding, valid [N, tau]).
    """
    n = cams.num
    axes = cams.oaxis[:, :3]
    cosang = jnp.matmul(axes, axes.T, precision=HIGHEST)
    ok = visdata & (cosang >= jnp.cos(jnp.deg2rad(60.0)))
    if sequence != -1:
        idx = jnp.arange(n)
        ok = ok & (jnp.abs(idx[:, None] - idx[None, :]) <= sequence)
    d = jnp.where(ok, distances, jnp.inf)
    order = jnp.argsort(d, axis=1)
    views = order[:, :tau].astype(jnp.int32)
    valid = jnp.take_along_axis(d, order[:, :tau], axis=1) < jnp.inf
    return jnp.where(valid, views, -1), valid


def add_images(cams: CameraSet, pyr: PyramidSet, visdata: jnp.ndarray,
               level: int, coord, normal, vmask, ref):
    """Add visdata neighbors of the reference that see the patch
    (reference optim.cpp:398-444): projection strictly inside the image,
    edge-map pass at the projection, ray-to-center within 60 deg of the
    normal. coord/normal [B, 4]; vmask [B, N]; ref [B]."""
    n = cams.num
    ns = jnp.arange(n)
    cand = visdata[ref] & ~vmask                         # [B, N]

    ic = project(cams.P[None, :], coord[:, None, :], level)
    w = pyr.widths[level].astype(ic.dtype)[None]
    h = pyr.heights[level].astype(ic.dtype)[None]
    inside = ((ic[..., 0] >= 0.0) & (ic[..., 0] < w - 1)
              & (ic[..., 1] >= 0.0) & (ic[..., 1] < h - 1))

    edge = edge_at(pyr, ns[None], level, ic[..., 0], ic[..., 1]) > 0.0

    ray = cams.center[None, :, :] - coord[:, None, :]
    ray = ray / jnp.linalg.norm(ray[..., :3], axis=-1, keepdims=True)
    facing = jnp.einsum("bnk,bk->bn", ray[..., :3], normal[:, :3],
                        precision=HIGHEST) \
        >= jnp.cos(jnp.deg2rad(60.0))

    return vmask | (cand & inside & edge & facing)


def remove_images_edge(pyr: PyramidSet, cams: CameraSet, level: int,
                       coord, vmask):
    """Keep only views whose edge map passes at the patch projection
    (reference optim.cpp:385-396)."""
    n = cams.num
    ns = jnp.arange(n)
    ic = project(cams.P[None, :], coord[:, None, :], level)
    edge = edge_at(pyr, ns[None], level, ic[..., 0], ic[..., 1]) > 0.0
    return vmask & edge


# Batch ceiling for one grab_masked trace: every (patch, view) pair of
# the batch holds its wsize^2 x 3 window and 4 gathered taps per sample;
# at cloud scale (131k patches x 12 views) that is several GB of
# temporaries for one call. Chunks run through one sequential lax.map of
# a single compiled body (memory_analysis on an H100: PERF.md).
GRAB_CHUNK = 8192


def grab_masked(cams, pyr, level, wsize, coord, normal, ref, vmask):
    """Textures for every view in vmask, axes from the reference view.
    Returns (texs [B, N, S2, 3] normalized, ok [B, N]). Batches beyond
    GRAB_CHUNK rows are processed in lax.map chunks."""
    b = coord.shape[0]
    if b > GRAB_CHUNK:
        # pad up to a chunk multiple (any batch size must chunk, not
        # silently fall back to the ~19 GB unchunked compile); pad rows
        # replicate row 0 with vmask=False so every grab is gated off
        nchunk = -(-b // GRAB_CHUNK)
        bp = nchunk * GRAB_CHUNK
        if bp != b:
            def padrep(a):
                return jnp.concatenate(
                    [a, jnp.broadcast_to(a[:1], (bp - b,) + a.shape[1:])])
            coord, normal, ref = map(padrep, (coord, normal, ref))
            vmask = jnp.concatenate(
                [vmask, jnp.zeros((bp - b,) + vmask.shape[1:], bool)])
        cb = GRAB_CHUNK

        def split(a):
            return a.reshape((nchunk, cb) + a.shape[1:])

        def body(args):
            c, nrm, r, vm = args
            return _grab_masked_one(cams, pyr, level, wsize, c, nrm, r,
                                    vm)

        texs, ok = jax.lax.map(body, (split(coord), split(normal),
                                      split(ref), split(vmask)))
        return (texs.reshape((bp,) + texs.shape[2:])[:b],
                ok.reshape((bp,) + ok.shape[2:])[:b])
    return _grab_masked_one(cams, pyr, level, wsize, coord, normal, ref,
                            vmask)


def _grab_masked_one(cams, pyr, level, wsize, coord, normal, ref, vmask):
    n = cams.num
    px, py = _patch_axes(cams, level, ref, coord, normal)
    views = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None],
                             vmask.shape)
    texs, ok = grab_tex(cams, pyr, level, wsize, coord, px, py, normal,
                        views, vmask)
    return normalize_tex(texs, ok), ok


def constraint_images(cams, pyr, level, wsize, coord, normal, ref, vmask,
                      ncc_threshold):
    """Keep views with non-robust INCC vs the reference < 1 - thr
    (reference optim.cpp:192-206 via setINCCs robust=0). The reference
    view always stays."""
    texs, ok = grab_masked(cams, pyr, level, wsize, coord, normal, ref,
                           vmask)
    b = coord.shape[0]
    ref_tex = texs[jnp.arange(b), ref][:, None]
    incc = 1.0 - ncc_dot(ref_tex, texs)
    ref_ok = ok[jnp.arange(b), ref]
    incc = jnp.where(ok & ref_ok[:, None], incc, 2.0)
    keep = vmask & (incc < 1.0 - ncc_threshold)
    return keep.at[jnp.arange(b), ref].set(vmask[jnp.arange(b), ref])


def filter_images_by_angle(cams, coord, normal, ref, vmask,
                           angle_threshold):
    """Drop views with incidence beyond the threshold; if the reference
    fails, the whole set is cleared (reference optim.cpp:124-148)."""
    ray = cams.center[None, :, :] - coord[:, None, :]
    ray = ray / jnp.linalg.norm(ray[..., :3], axis=-1, keepdims=True)
    good = jnp.einsum("bnk,bk->bn", ray[..., :3], normal[:, :3],
                      precision=HIGHEST) \
        >= jnp.cos(angle_threshold)
    b = coord.shape[0]
    ref_good = good[jnp.arange(b), ref]
    return jnp.where(ref_good[:, None], vmask & good,
                     jnp.zeros_like(vmask))


def sort_images(cams: CameraSet, level: int, coord, normal, ref, vmask,
                t: int):
    """Greedy min-unit view ordering with 10-degree cone penalties
    (reference optim.cpp:284-321, newm==1): repeatedly take the view with
    the smallest effective resolution unit, then penalize remaining views
    whose rays are within ~10 deg of the taken one.

    Returns (views [B, T] int32 -1-padded, valid [B, T]); slot 0 is the
    reference (its unit is forced to 0, optim.cpp:297).
    """
    b, n = vmask.shape
    ray = cams.center[None, :, :] - coord[:, None, :]
    ray = ray / jnp.linalg.norm(ray[..., :3], axis=-1, keepdims=True)
    ray3 = ray[..., :3]
    dots = jnp.einsum("bnk,bk->bn", ray3, normal[:, :3], precision=HIGHEST)
    unit = get_unit(cams, jnp.arange(n)[None], coord[:, None, :], level)
    units = jnp.where((dots > 0.0) & vmask,
                      unit / jnp.where(dots > 0.0, dots, 1.0), HUGE)
    units = units.at[jnp.arange(b), ref].set(0.0)
    # reference behavior: fewer than 2 usable views -> empty set
    usable = (units < HUGE).sum(axis=1)
    threshold = 1.0 - jnp.cos(jnp.deg2rad(10.0))

    def body(state, _):
        units_c, = state
        pick = jnp.argmin(units_c, axis=1)                    # [B]
        pick_ok = jnp.take_along_axis(units_c, pick[:, None], 1)[:, 0] < HUGE
        rsel = ray3[jnp.arange(b), pick]                      # [B, 3]
        cone = 1.0 - jnp.einsum("bnk,bk->bn", ray3, rsel, precision=HIGHEST)
        ftmp = jnp.minimum(threshold, jnp.maximum(threshold / 2.0, cone))
        units_c = units_c * (threshold / ftmp)
        units_c = units_c.at[jnp.arange(b), pick].set(HUGE)
        out = jnp.where(pick_ok, pick.astype(jnp.int32), -1)
        return (units_c,), (out, pick_ok)

    (_,), (views, valid) = jax.lax.scan(body, (units,), None, length=t)
    views = views.T                                           # [B, T]
    valid = valid.T & (usable >= 2)[:, None]
    return jnp.where(valid, views, -1), valid


def check_angles(cams: CameraSet, coord, views, valid, min_angle,
                 max_angle):
    """Fail unless some view pair subtends an angle in (min, max)
    (reference photoSetS.cpp:164-189). Returns ok [B]."""
    vid = jnp.maximum(views, 0)
    ray = cams.center[vid] - coord[:, None, :]                # [B, T, 4]
    ray = ray / jnp.linalg.norm(ray[..., :3], axis=-1, keepdims=True)
    dots = jnp.einsum("bik,bjk->bij", ray[..., :3], ray[..., :3],
                      precision=HIGHEST)
    ang = jnp.arccos(jnp.clip(dots, -1.0, 1.0))
    pair = valid[:, :, None] & valid[:, None, :]
    t = views.shape[1]
    iu = jnp.triu_indices(t, k=1)
    hits = ((ang > min_angle) & (ang < max_angle) & pair)[:, iu[0], iu[1]]
    return hits.any(axis=1)


def set_ref_image(cams, pyr, level, wsize, tn: int, coord, normal, ref,
                  vmask):
    """New reference = target view minimizing the summed pairwise robust
    INCC (reference optim.cpp:208-254). Returns (ref, ok) where ok=False
    when no target view remains."""
    texs, gok = grab_masked(cams, pyr, level, wsize, coord, normal, ref,
                            vmask)
    n = vmask.shape[1]
    dots = jnp.einsum("bisc,bjsc->bij", texs, texs,
                      precision=HIGHEST) / texs[0, 0].size
    incc = robustincc(1.0 - dots)
    pair_ok = gok[:, :, None] & gok[:, None, :]
    incc = jnp.where(pair_ok, incc, 2.0)
    incc = incc * (1.0 - jnp.eye(n)[None])
    sums = jnp.where(vmask[:, None, :], incc, 0.0).sum(axis=2)
    is_target = (jnp.arange(n) < tn)[None]
    cand = vmask & is_target
    sums = jnp.where(cand, sums, jnp.inf)
    new_ref = jnp.argmin(sums, axis=1).astype(jnp.int32)
    ok = cand.any(axis=1)
    return jnp.where(ok, new_ref, ref), ok
