"""Seed generation: epipolar feature matching -> initial patches.

Batched port of CSeed (reference source/pmvs/seed.cpp): instead of
per-thread sequential candidate trials, all (feature, view) epipolar
matches are gated at once, the best few candidates per feature are
triangulated and refined as one batch, and one winner per grid cell is
kept (the reference keeps the best of the first countThreshold0=2
successes per feature and the first successful feature per cell,
seed.cpp:133-205 - a thread-order-dependent rule; we keep the
best-scoring success per cell, which matches at the aggregate level).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom.cameras import (
    HIGHEST, CameraSet, epipolar_distance, fundamental_matrix,
    level_projection, project, triangulate_dlt,
)
from ..image.pyramid import PyramidSet
from ..image.sample import mask_all
from .config import EngineConfig, Thresholds
from .grid import cell_of
from .patches import PatchCloud, append_patches, empty_cloud
from .process import process_candidates_chunked


class SeedCandidates(NamedTuple):
    coord: jax.Array    # [B, 4] triangulated position
    ref: jax.Array      # [B] reference image index
    other: jax.Array    # [B] matched image index
    cell: jax.Array     # [B] flat cell key in the reference image
    valid: jax.Array    # [B]


def collect_seed_candidates(cams: CameraSet, pyr: PyramidSet,
                            cfg: EngineConfig, thr: Thresholds,
                            feats: dict, ref_views, ref_views_valid,
                            per_view_cap: int = 4,
                            feat_chunk: int = 2048):
    """Epipolar-gated candidate pairs for every target image's features.

    feats: dict of [N, F] arrays from ops.detect.detect_features.
    ref_views: [N, tau] candidate views per reference image
    (collectImages). Returns SeedCandidates with
    B = tn * F * tau * per_view_cap rows.

    Mirrors collectCandidates (seed.cpp:271-323): same-type features
    within ep-threshold of the epipolar line, triangulated by two-view
    DLT, gated by positive reference depth and the all-view mask; ranked
    by |dist(C_ref) - dist(C_other)| (closest first). The per-(feature,
    view) fan-in is capped at `per_view_cap` best-EPD matches instead of
    "all within 2px" (SURVEY.md 7, raggedness).

    Memory is bounded: instead of materializing the full
    [TN, tau, F, F'] EPD tensor (multi-GB at level-0 feature counts),
    a scan walks (ref image, ref-feature chunk, other-feature chunk)
    tiles of at most [tau, feat_chunk, feat_chunk] and carries running
    per-(feature, view) top-`per_view_cap` matches - the batched
    equivalent of the reference's per-cell epipolar-band walk
    (seed.cpp:207-267 collectCells).
    """
    tn, tau = cfg.tn, cfg.tau
    n, f = feats["x"].shape
    cap = per_view_cap
    fx = feats["x"].astype(jnp.float32)
    fy = feats["y"].astype(jnp.float32)
    ftype = feats["type"]
    fvalid = feats["valid"]
    ones = jnp.ones_like(fx)
    p_all = jnp.stack([fx, fy, ones], axis=-1)            # [N, F, 3]

    ref_ids = jnp.arange(tn)
    # fundamental matrices ref -> each candidate view  [TN, tau, 3, 3]
    vid = jnp.maximum(ref_views[:tn], 0)
    F_mat = fundamental_matrix(cams.P[ref_ids][:, None], cams.P[vid],
                               cfg.level)

    # pad the feature axis to a chunk multiple
    cf = min(feat_chunk, f)
    fp = -(-f // cf) * cf
    padf = fp - f

    def padded(a, fill=0):
        if padf == 0:
            return a
        width = [(0, 0), (0, padf)] + [(0, 0)] * (a.ndim - 2)
        return jnp.pad(a, width, constant_values=fill)

    p_pad = padded(p_all)
    type_pad = padded(ftype)
    valid_pad = padded(fvalid, fill=False)
    nf = fp // cf

    def body(carry, s):
        scores, idxs = carry              # [TN, tau, FP, cap] each
        r = s // (nf * nf)
        rem = s % (nf * nf)
        i = rem // nf
        j = rem % nf
        vr = vid[r]                                        # [tau]
        Fr = F_mat[r]                                      # [tau, 3, 3]
        p0c = jax.lax.dynamic_slice(
            p_pad[r], (i * cf, 0), (cf, 3))                # [cf, 3]
        p1c = jax.lax.dynamic_slice(
            p_pad[vr], (0, j * cf, 0), (tau, cf, 3))       # [tau, cf, 3]
        epd = epipolar_distance(
            Fr[:, None, None], p0c[None, :, None, :],
            p1c[:, None, :, :])                            # [tau, cf, cf]
        t0c = jax.lax.dynamic_slice(type_pad[r], (i * cf,), (cf,))
        v0c = jax.lax.dynamic_slice(valid_pad[r], (i * cf,), (cf,))
        t1c = jax.lax.dynamic_slice(type_pad[vr], (0, j * cf),
                                    (tau, cf))
        v1c = jax.lax.dynamic_slice(valid_pad[vr], (0, j * cf),
                                    (tau, cf))
        ok = (t0c[None, :, None] == t1c[:, None, :]) \
            & v0c[None, :, None] & v1c[:, None, :] \
            & ref_views_valid[r][:, None, None] & (epd < thr.ep)
        score = jnp.where(ok, -epd, -jnp.inf)              # [tau, cf, cf]

        old_s = jax.lax.dynamic_slice(
            scores, (r, 0, i * cf, 0), (1, tau, cf, cap))[0]
        old_i = jax.lax.dynamic_slice(
            idxs, (r, 0, i * cf, 0), (1, tau, cf, cap))[0]
        cand_i = jnp.broadcast_to(
            (j * cf + jnp.arange(cf, dtype=jnp.int32))[None, None, :],
            score.shape).astype(jnp.int32)
        all_s = jnp.concatenate([old_s, score], axis=-1)
        all_i = jnp.concatenate([old_i, cand_i], axis=-1)
        top, ti = jax.lax.top_k(all_s, cap)
        new_i = jnp.take_along_axis(all_i, ti, axis=-1)
        scores = jax.lax.dynamic_update_slice(
            scores, top[None], (r, 0, i * cf, 0))
        idxs = jax.lax.dynamic_update_slice(
            idxs, new_i[None], (r, 0, i * cf, 0))
        return (scores, idxs), None

    init = (jnp.full((tn, tau, fp, cap), -jnp.inf, p_all.dtype),
            jnp.zeros((tn, tau, fp, cap), jnp.int32))
    (top, idx), _ = jax.lax.scan(body, init,
                                 jnp.arange(tn * nf * nf))
    top = top[:, :, :f]
    idx = jnp.clip(idx[:, :, :f], 0, f - 1)
    ok = jnp.isfinite(top)

    # triangulate the selected pairs (seed.cpp:340-384)
    P0l = level_projection(cams.P[ref_ids], cfg.level)
    P1l = level_projection(cams.P[vid], cfg.level)
    ic0 = jnp.stack([fx[ref_ids], fy[ref_ids]], -1)       # [TN, F, 2]
    ic1_all = jnp.stack([fx, fy], -1)                     # [N, F', 2]
    ic1 = jnp.take_along_axis(
        ic1_all[vid][:, :, None, :, :],
        idx[..., None], axis=3)                           # [TN,tau,F,C,2]
    coord = triangulate_dlt(
        P0l[:, None, None, None], P1l[:, :, None, None],
        ic0[:, None, :, None, :], ic1)                    # [TN,tau,F,C,4]

    # gates: positive depth in the reference view (seed.cpp:313),
    # all-view mask (seed.cpp:314)
    zrow = level_projection(cams.P[ref_ids], cfg.level)[:, 2]
    depth = jnp.einsum("tk,t...k->t...", zrow, coord, precision=HIGHEST)
    ok = ok & (depth > 0.0)
    ok = ok & mask_all(pyr, cams.P, coord, cfg.level)
    # useBound gate (reference seed.cpp:314)
    from ..image.sample import inside_bimages
    ok = ok & inside_bimages(pyr, cams.P, coord, cfg.level,
                             cfg.bindexes)

    # ranking key: |dist to ref center - dist to other center|
    d0 = jnp.linalg.norm(coord[..., :3]
                         - cams.center[ref_ids][:, None, None, None, :3],
                         axis=-1)
    d1 = jnp.linalg.norm(coord[..., :3]
                         - cams.center[vid][:, :, None, None, :3], axis=-1)
    ddiff = jnp.abs(d0 - d1)

    # flat cell key of the source feature in the reference image
    cix = (jnp.floor(fx[ref_ids] + 0.5).astype(jnp.int32) // cfg.csize)
    ciy = (jnp.floor(fy[ref_ids] + 0.5).astype(jnp.int32) // cfg.csize)
    cell = (ref_ids[:, None] * cfg.gh
            + jnp.clip(ciy, 0, cfg.gh - 1)) * cfg.gw \
        + jnp.clip(cix, 0, cfg.gw - 1)
    cell = jnp.broadcast_to(cell[:, None, :, None], ok.shape)

    other = jnp.broadcast_to(vid[:, :, None, None], ok.shape)
    refb = jnp.broadcast_to(ref_ids[:, None, None, None], ok.shape)

    flat = lambda a: a.reshape((-1,) + a.shape[4:])
    return SeedCandidates(
        coord=flat(coord), ref=flat(refb).astype(jnp.int32),
        other=flat(other).astype(jnp.int32), cell=flat(cell),
        valid=flat(ok)), flat(ddiff)


import functools as _functools


@_functools.partial(jax.jit, static_argnames=("cfg",))
def seed_discover(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                  thr: Thresholds, feats, ref_views, ref_views_valid):
    """Seed stage 1 (cheap): epipolar candidate collection + per-cell
    pre-selection. Returns (SeedCandidates, keep mask, surviving count);
    the host reads the count and sizes seed_commit's refine batch to it
    (the same discover/commit split expansion uses - refining the
    worst-case tn*F*seed_cand budget wasted most of the seed phase on
    padding)."""
    cand, ddiff = collect_seed_candidates(
        cams, pyr, cfg, thr, feats, ref_views, ref_views_valid)
    b = cand.valid.shape[0]

    # per-cell pre-selection: keep the closest-ddiff candidates per cell
    # so the refine batch stays bounded: rank candidates within cells
    key = jnp.where(cand.valid, cand.cell, cfg.tn * cfg.gh * cfg.gw)
    order = jnp.lexsort((ddiff, key))
    skey = key[order]
    srank = _run_rank(skey)
    keep_sorted = srank < cfg.seed_cand
    keep = jnp.zeros(b, bool).at[order].set(keep_sorted & (
        skey < cfg.tn * cfg.gh * cfg.gw))
    return cand, keep, keep.sum()


@_functools.partial(jax.jit,
                    static_argnames=("cfg", "budget", "refine_iters"))
def seed_commit(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                thr: Thresholds, visdata, cand: SeedCandidates, keep,
                cloud: PatchCloud, budget: int, refine_iters: int = 12):
    """Seed stage 2: refine the surviving candidates ([budget] batch)
    and keep one winner per reference cell (seed.cpp:186-199)."""
    sel = jnp.nonzero(keep, size=budget, fill_value=0)[0]
    sel_valid = keep[sel]

    coord = cand.coord[sel]
    ref = cand.ref[sel]
    other = cand.other[sel]
    cell = cand.cell[sel]

    # initial patch: normal toward the reference optical center
    normal = cams.center[ref] - coord
    normal = normal / jnp.linalg.norm(normal[..., :3], axis=-1,
                                      keepdims=True)
    normal = normal.at[:, 3].set(0.0)

    nb = coord.shape[0]
    vmask = jnp.zeros((nb, cfg.n), bool)
    vmask = vmask.at[jnp.arange(nb), ref].set(True)
    vmask = vmask.at[jnp.arange(nb), other].set(True)

    res = process_candidates_chunked(cams, pyr, cfg, thr, visdata,
                                     coord, normal, vmask, ref, depth=0,
                                     active=sel_valid,
                                     refine_iters=refine_iters)
    success = res.success & sel_valid

    # one winner per reference cell by patch.score (seed.cpp:186-199)
    score = jnp.maximum(0.0, res.ncc - thr.ncc) \
        * (res.images >= 0).sum(axis=1)
    win = _argmax_per_group(cell, score, success,
                            cfg.tn * cfg.gh * cfg.gw)
    keep_mask = success & win

    new = PatchCloud(
        coord=res.coord, normal=res.normal, ncc=res.ncc,
        images=res.images, grids=res.grids, vimages=res.vimages,
        vgrids=res.vgrids, timages=res.timages, dscale=res.dscale,
        ascale=res.ascale,
        dflag=jnp.zeros(nb, jnp.int32), alive=keep_mask)
    out, dropped = append_patches(cloud, new, keep_mask)
    return out, dropped


def run_seed(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
             thr: Thresholds, visdata, feats, ref_views, ref_views_valid,
             cloud: PatchCloud, refine_iters: int = 12,
             ensure_capacity=None):
    """Full seeding phase: candidates -> refine -> one winner per cell.

    Returns (cloud with seed patches appended, dropped-overflow count)
    (reference CSeed::run, seed.cpp:40-107). Host orchestrator over the
    two jitted stages: discover on the full candidate fan-out, one
    scalar readback, then commit with the refine batch sized to the
    real candidate count (1.5x-step buckets, <= 33% padding).

    `ensure_capacity(needed)`: optional callback returning a cloud with
    capacity for `needed` more patches - the engine grows its arrays
    BEFORE the commit so no accepted seed can overflow (the round-3
    grow-then-reseed-from-scratch loop cost up to 4 full seed passes;
    VERDICT r3 weak 4)."""
    from .engine import _bucket15
    cand, keep, nkeep = seed_discover(cams, pyr, cfg, thr, feats,
                                      ref_views, ref_views_valid)
    b = int(cand.valid.shape[0])
    cap = min(b, cfg.tn * feats["x"].shape[1] * cfg.seed_cand)
    budget = min(_bucket15(max(int(nkeep), 1), cap), cap)
    if ensure_capacity is not None:
        cloud = ensure_capacity(budget)
    return seed_commit(cams, pyr, cfg, thr, visdata, cand, keep, cloud,
                       budget, refine_iters=refine_iters)


def _run_rank(sorted_keys):
    """Rank of each element within its equal-key run (sorted input)."""
    n = sorted_keys.shape[0]
    idx = jnp.arange(n)
    is_start = jnp.concatenate(
        [jnp.ones(1, bool), sorted_keys[1:] != sorted_keys[:-1]])
    start_idx = jax.lax.cummax(jnp.where(is_start, idx, 0))
    return idx - start_idx


def _argmax_per_group(group, score, valid, num_groups: int):
    """Boolean mask selecting the argmax-score row of each group."""
    flat = jnp.full(num_groups + 1, -jnp.inf)
    g = jnp.where(valid, group, num_groups)
    flat = flat.at[g].max(jnp.where(valid, score, -jnp.inf))
    best = flat[g]
    is_best = valid & (score >= best)
    # tie-break: smallest row index wins
    n = group.shape[0]
    idxflat = jnp.full(num_groups + 1, n, jnp.int32)
    idxflat = idxflat.at[jnp.where(is_best, g, num_groups)].min(
        jnp.where(is_best, jnp.arange(n, dtype=jnp.int32), n))
    return is_best & (jnp.arange(n) == idxflat[g])
