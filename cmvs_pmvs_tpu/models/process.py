"""The per-candidate pipeline: preProcess -> refine -> postProcess.

Shared by seeding and expansion (reference seed.cpp:387-414 and
expand.cpp:200-256 both call COptim::preProcess / refinePatch /
postProcess, optim.cpp:95-190). Operates on [B] batches of candidate
patches with dense view masks; every gate is a mask update, and the final
`success` mask tells callers which candidates became patches.

Deviations from the reference, by design (see SURVEY.md section 7 "hard
parts"): candidates are processed in parallel waves rather than
sequentially per thread, and stored view sets are capped at t_store slots.
The depth>=2 gain/quad check (optim.cpp:363-383) runs inside the filter
stage instead of per candidate.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom.cameras import HIGHEST, CameraSet
from ..image.pyramid import PyramidSet
from ..image.sample import mask_all
from ..ops.refine import make_problem, refine_patches, set_scales
from .config import EngineConfig, Thresholds
from .grid import GridState, cell_of, is_visible
from .patches import PatchCloud
from . import views as V


class ProcessResult(NamedTuple):
    success: jax.Array    # [B] bool
    coord: jax.Array      # [B, 4]
    normal: jax.Array     # [B, 4]
    ncc: jax.Array        # [B]
    images: jax.Array     # [B, T_store] int32, slot 0 = reference
    grids: jax.Array      # [B, T_store, 2]
    vimages: jax.Array    # [B, T_store]
    vgrids: jax.Array     # [B, T_store, 2]
    timages: jax.Array    # [B]
    dscale: jax.Array     # [B]
    ascale: jax.Array     # [B]
    view_drops: jax.Array  # [] total views lost to the t_store cap


def _set_grids(cams, cfg: EngineConfig, coord, views, valid):
    ix, iy = cell_of(cams, cfg.level, cfg.csize, coord[:, None, :], views)
    return jnp.stack([ix, iy], axis=-1), valid


# Batch ceiling for one process_candidates trace: the postProcess
# texture passes and the refine loop hold [B, views, wsize^2, 3]
# windows and their gathers for every candidate; at the full-scene
# seed commit (115k candidates x 12 views) unchunked, a batch would take
# a large share of an 80 GB card for temporaries. 8192 candidates per
# chunk matches the refine evaluator's bench batch (memory_analysis on
# an H100 at the full protocol: PERF.md).
PROCESS_CHUNK = 8192


def process_candidates_chunked(cams: CameraSet, pyr: PyramidSet,
                               cfg: EngineConfig, thr: Thresholds,
                               visdata, coord, normal, vmask, ref,
                               depth: int,
                               grid: GridState | None = None,
                               cloud: PatchCloud | None = None,
                               active=None, refine_iters: int = 12,
                               chunk: int = PROCESS_CHUNK
                               ) -> ProcessResult:
    """process_candidates over batch chunks via one sequential lax.map
    (one trace/compile of the body regardless of batch size); falls
    back to the plain call when the batch already fits."""
    b = coord.shape[0]
    if active is None:
        active = jnp.ones(b, bool)
    if b <= chunk:
        return process_candidates(cams, pyr, cfg, thr, visdata, coord,
                                  normal, vmask, ref, depth=depth,
                                  grid=grid, cloud=cloud, active=active,
                                  refine_iters=refine_iters)
    # pad the batch up to a chunk multiple (a 2-adically poor batch size
    # must not silently fall back to the unchunked ~25 GB compile); pad
    # rows replicate row 0 with active=False so they cost nothing and
    # produce no drops, then the results are sliced back to b
    nchunk = -(-b // chunk)
    bp = nchunk * chunk
    if bp != b:
        def padrep(a):
            return jnp.concatenate(
                [a, jnp.broadcast_to(a[:1], (bp - b,) + a.shape[1:])])
        coord, normal, vmask, ref = map(padrep,
                                        (coord, normal, vmask, ref))
        active = jnp.concatenate([active, jnp.zeros(bp - b, bool)])
    cb = chunk

    def split(a):
        return a.reshape((nchunk, cb) + a.shape[1:])

    def body(args):
        c, n, vm, r, act = args
        return process_candidates(cams, pyr, cfg, thr, visdata, c, n,
                                  vm, r, depth=depth, grid=grid,
                                  cloud=cloud, active=act,
                                  refine_iters=refine_iters)

    res = jax.lax.map(body, (split(coord), split(normal), split(vmask),
                             split(ref), split(active)))

    def merge(a):
        return a.reshape((bp,) + a.shape[2:])[:b]

    return ProcessResult(
        success=merge(res.success), coord=merge(res.coord),
        normal=merge(res.normal), ncc=merge(res.ncc),
        images=merge(res.images), grids=merge(res.grids),
        vimages=merge(res.vimages), vgrids=merge(res.vgrids),
        timages=merge(res.timages), dscale=merge(res.dscale),
        ascale=merge(res.ascale), view_drops=res.view_drops.sum())


def process_candidates(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                       thr: Thresholds, visdata, coord, normal, vmask, ref,
                       depth: int,
                       grid: GridState | None = None,
                       cloud: PatchCloud | None = None,
                       active=None,
                       refine_iters: int = 12) -> ProcessResult:
    """Run the full candidate pipeline on a [B] batch.

    visdata: [N, N] bool adjacency; vmask [B, N] initial views; ref [B].
    depth: phase counter (0 during seeding; >=1 enables vimages via the
    depth maps in `grid`/`cloud`).
    """
    b = coord.shape[0]
    if active is None:
        active = jnp.ones(b, bool)

    # ---- preProcess (optim.cpp:95-122) ----
    vmask = V.add_images(cams, pyr, visdata, cfg.level, coord, normal,
                         vmask, ref)
    vmask = V.constraint_images(cams, pyr, cfg.level, cfg.wsize, coord,
                                normal, ref, vmask, thr.ncc_before)
    views, vvalid = V.sort_images(cams, cfg.level, coord, normal, ref,
                                  vmask, cfg.t_store)
    nview = vvalid.sum(axis=1)
    ok = active & (nview >= cfg.min_image_num)

    dscale, ascale = set_scales(
        cams, cfg.level, cfg.wsize, coord,
        views[:, :cfg.tau], vvalid[:, :cfg.tau])
    ok = ok & V.check_angles(cams, coord, views, vvalid,
                             thr.max_angle, thr.angle1)

    # ---- refine (optim.cpp:496-658) ----
    prob = make_problem(cams, cfg.level, coord, normal,
                        views[:, :cfg.tau], vvalid[:, :cfg.tau], dscale,
                        cfg.min_image_num)
    # final ncc is recomputed below from the fused pairwise matrix, so
    # skip the refine kernel's own scoring pass
    coord, normal, _, _ = refine_patches(
        cams, pyr, cfg.level, cfg.wsize, prob, coord, normal,
        num_iters=refine_iters, active=ok, with_ncc=False)

    # ---- postProcess (optim.cpp:150-190) ----
    # re-derive the view mask from the refined geometry
    vmask = jnp.zeros_like(vmask).at[
        jnp.arange(b)[:, None], jnp.maximum(views, 0)].max(vvalid)
    ok = ok & (mask_all(pyr, cams.P, coord, cfg.level))
    # useBound gate (reference optim.cpp:153)
    from ..image.sample import inside_bimages
    ok = ok & inside_bimages(pyr, cams.P, coord, cfg.level,
                             cfg.bindexes)
    vmask = V.add_images(cams, pyr, visdata, cfg.level, coord, normal,
                         vmask, ref)

    # Fused texture passes: the refined geometry is fixed from here on,
    # so ONE masked grab + ONE pairwise NCC matrix serves the constraint
    # pass, the reference re-pick, the second constraint pass, and the
    # final weighted score. (The reference re-grabs the same windows in
    # each of setINCCs / setRefImage / computeINCC, optim.cpp:157-189 -
    # the textures are identical every time.)
    from ..ops.texture import robustincc, unrobustincc
    texs, gok = V.grab_masked(cams, pyr, cfg.level, cfg.wsize, coord,
                              normal, ref, vmask)
    n = vmask.shape[1]
    flat = texs.reshape(b, n, -1)
    D = jnp.einsum("bik,bjk->bij", flat, flat,
                   precision=HIGHEST) / flat.shape[-1]
    pair_ok = gok[:, :, None] & gok[:, None, :]
    rows_b = jnp.arange(b)

    def constraint(vm, r):
        # keep views with non-robust INCC vs the reference < 1 - thr
        # (optim.cpp:192-206); the reference view always stays
        dref = jnp.take_along_axis(D, r[:, None, None], axis=1)[:, 0]
        okp = gok & gok[rows_b, r][:, None]
        incc = jnp.where(okp, 1.0 - dref, 2.0)
        keep = vm & (incc < 1.0 - thr.ncc)
        return keep.at[rows_b, r].set(vm[rows_b, r])

    vmask = constraint(vmask, ref)
    vmask = V.filter_images_by_angle(cams, coord, normal, ref, vmask,
                                     thr.angle1)
    ok = ok & (vmask.sum(axis=1) >= cfg.min_image_num)

    # reference re-pick: target view minimizing the summed pairwise
    # robust INCC (optim.cpp:208-254), from the same D matrix
    rincc = jnp.where(pair_ok, robustincc(1.0 - D), 2.0)
    rincc = rincc * (1.0 - jnp.eye(n)[None])
    sums = jnp.where(vmask[:, None, :], rincc, 0.0).sum(axis=2)
    cand_r = vmask & (jnp.arange(n) < cfg.tn)[None]
    sums = jnp.where(cand_r, sums, jnp.inf)
    ref_ok = cand_r.any(axis=1)
    ref = jnp.where(ref_ok, jnp.argmin(sums, axis=1).astype(jnp.int32),
                    ref)
    ok = ok & ref_ok
    vmask = constraint(vmask, ref)
    ok = ok & (vmask.sum(axis=1) >= cfg.min_image_num)

    # materialize the stored view list (ref first); count views lost to
    # the t_store cap (the reference stores unbounded _images - VERDICT
    # r2 asks for this truncation to be observable)
    view_drops = jnp.where(
        ok, jnp.maximum(vmask.sum(axis=1) - cfg.t_store, 0), 0).sum()
    views, vvalid = V.sort_images(cams, cfg.level, coord, normal, ref,
                                  vmask, cfg.t_store)
    grids, _ = _set_grids(cams, cfg, coord, views, vvalid)
    views = jnp.where(vvalid, views, -1)
    timages = (vvalid & (views >= 0) & (views < cfg.tn)).sum(
        axis=1).astype(jnp.int32)

    # final score: weighted robust INCC over the first tau views
    # (optim.cpp:652 + computeINCC :875-938), again from D
    from ..ops.refine import compute_units
    tviews = views[:, :cfg.tau]
    tvalid = vvalid[:, :cfg.tau]
    vid = jnp.maximum(tviews, 0)
    units = compute_units(cams, cfg.level, coord, normal, tviews, tvalid)
    w = jnp.minimum(1.0, units[:, 0:1] / jnp.maximum(units, 1e-30))
    w = w.at[:, 0].set(1.0)
    dref = D[rows_b[:, None], vid[:, 0:1], vid]             # [B, tau]
    p_ok = (gok[rows_b[:, None], vid] & gok[rows_b, vid[:, 0]][:, None]
            & tvalid)
    p_ok = p_ok.at[:, 0].set(False)
    w = jnp.where(p_ok, w, 0.0)
    incc_t = jnp.where(p_ok, robustincc(1.0 - dref), 2.0)
    total = w.sum(axis=-1)
    score = (incc_t * w).sum(axis=-1) / jnp.where(total == 0.0, 1.0,
                                                  total)
    score = jnp.where((total == 0.0) | ~gok[rows_b, vid[:, 0]], 2.0,
                      score)
    ncc = 1.0 - unrobustincc(score)

    # vimages: extra target views passing the depth test + edge
    # (patchOrganizerS.cpp:420-450), only once depth maps exist
    vimages = jnp.full_like(views, -1)
    vgrids = jnp.zeros_like(grids)
    if depth >= 1 and grid is not None and cloud is not None:
        vimages, vgrids = set_vimages(
            cams, pyr, cfg, thr, grid, cloud, coord, normal, views, vvalid,
            cfg.t_store)

    return ProcessResult(success=ok, coord=coord, normal=normal, ncc=ncc,
                         images=views, grids=grids, vimages=vimages,
                         vgrids=vgrids, timages=timages, dscale=dscale,
                         ascale=ascale, view_drops=view_drops)


def set_vimages(cams, pyr, cfg: EngineConfig, thr: Thresholds,
                grid: GridState, cloud: PatchCloud, coord, normal, views,
                vvalid, cap: int):
    """Discover depth-visible target views not already in the view list
    (reference patchOrganizerS.cpp:420-450): depth-test with
    strict=neighbor(0.5) plus an edge-map pass; returns -1-padded
    [B, cap] vimages and their cells."""
    b = coord.shape[0]
    tn = cfg.tn
    used = jnp.zeros((b, tn), bool)
    tv = jnp.where((views >= 0) & (views < tn), views, 0)
    used = used.at[jnp.arange(b)[:, None], tv].max(
        (views >= 0) & (views < tn))

    tgt = jnp.arange(tn)
    ix, iy = cell_of(cams, cfg.level, cfg.csize, coord[:, None, :],
                     jnp.broadcast_to(tgt[None], (b, tn)))
    vis = is_visible(cams, cloud, grid, cfg.level, cfg.csize,
                     coord[:, None, :], normal[:, None, :],
                     jnp.broadcast_to(tgt[None], (b, tn)), ix, iy,
                     thr.neighbor)
    from ..image.sample import edge_at
    from ..geom.cameras import project
    ic = project(cams.P[tgt][None], coord[:, None, :], cfg.level)
    edge = edge_at(pyr, tgt[None], cfg.level, ic[..., 0], ic[..., 1]) > 0.0
    cand = vis & edge & ~used                                  # [B, TN]

    # pack up to `cap` candidate target views per patch (pad when the
    # cluster has fewer target images than storage slots)
    order = jnp.argsort(~cand, axis=1)[:, :cap]                # Trues first
    got = jnp.take_along_axis(cand, order, axis=1)
    vimages = jnp.where(got, order.astype(jnp.int32), -1)
    vix = jnp.take_along_axis(ix, order, axis=1)
    viy = jnp.take_along_axis(iy, order, axis=1)
    vgrids = jnp.stack([vix, viy], axis=-1)
    if vimages.shape[1] < cap:
        pad = cap - vimages.shape[1]
        vimages = jnp.pad(vimages, ((0, 0), (0, pad)),
                          constant_values=-1)
        vgrids = jnp.pad(vgrids, ((0, 0), (0, pad), (0, 0)))
    return vimages, vgrids
