"""Patch expansion as vectorized frontier waves.

Batched port of CExpand (reference source/pmvs/expand.cpp): the
priority-queue of patches drained by threads becomes a frontier mask over
the cloud; each wave, every frontier patch proposes up to 6 tangent-plane
candidates (findEmptyBlocks, expand.cpp:108-180), candidates are gated,
deduplicated per cell, batch-refined, and the successes form the next
frontier. Per-cell attempt counters and the direction-failure bitmask
carry over exactly; ordering differs from the reference queue (score2
priority) by design - aggregate output is the comparison target
(SURVEY.md section 7).
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom.cameras import CameraSet, get_unit
from ..image.pyramid import PyramidSet
from ..image.sample import mask_all
from .config import EngineConfig, Thresholds
from .grid import (
    CellTable, GridState, build_cell_table, cell_of, is_neighbor,
    rebuild_depth_maps, rebuild_occupancy,
)
from .patches import PatchCloud, append_patches
from .process import process_candidates_chunked
from . import views as V

HUGE = 1.0e10


def _ortho(normal):
    """Tangent basis from a normal (reference numeric/vec4.hpp:303-322)."""
    z = normal[..., :3]
    ax, ay, az = jnp.abs(z[..., 0]), jnp.abs(z[..., 1]), jnp.abs(z[..., 2])
    x0 = jnp.stack([z[..., 1], -z[..., 0], jnp.zeros_like(az)], -1)
    x1 = jnp.stack([jnp.zeros_like(ax), z[..., 2], -z[..., 1]], -1)
    x2 = jnp.stack([-z[..., 2], jnp.zeros_like(ay), z[..., 0]], -1)
    x = jnp.where((ax > 0.5)[..., None], x0,
                  jnp.where((ay > 0.5)[..., None], x1, x2))
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    y = jnp.cross(z, x)
    zeros = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
    return (jnp.concatenate([x, zeros], -1),
            jnp.concatenate([y, zeros], -1))


def compute_radius(cams: CameraSet, cfg: EngineConfig, coord, normal,
                   images, ivalid):
    """2nd-smallest per-view fineness unit x csize
    (reference expand.cpp:182-198)."""
    from ..ops.refine import compute_units
    units = compute_units(cams, cfg.level, coord, normal, images, ivalid)
    two = -jax.lax.top_k(-units, 2)[0]          # two smallest
    return two[:, 1] * cfg.csize


def patch_unit(cams: CameraSet, cfg: EngineConfig, coord, images, ivalid):
    """Mean getUnit over the patch's views x csize
    (reference patchOrganizerS.cpp:653-661)."""
    vid = jnp.maximum(images, 0)
    u = get_unit(cams, vid, coord[:, None, :], cfg.level)
    cnt = jnp.maximum(ivalid.sum(axis=1), 1)
    return jnp.where(ivalid, u, 0.0).sum(axis=1) / cnt * cfg.csize


class WaveStats(NamedTuple):
    candidates: jax.Array
    accepted: jax.Array
    dropped: jax.Array     # successes lost to capacity overflow
    view_drops: jax.Array  # views lost to the t_store cap this wave


def find_empty_blocks(cams, cfg: EngineConfig, thr: Thresholds,
                      cloud: PatchCloud, tab: CellTable,
                      fsel, fok):
    """Per frontier patch, which of the 6 sectors lack neighbors
    (reference expand.cpp:108-180).

    Operates on the compacted frontier rows `fsel` [F] (mask `fok`) so
    every per-patch array here is [F]-shaped, not cloud-capacity-shaped;
    cell-table lookups resolve against the merged pgrids+vpgrids table
    (findNeighbors gathers both per cell, patchOrganizerS.cpp:573-589).
    Returns (cand_coord [F, 6, 4], cand_ok [F, 6])."""
    fcoord = cloud.coord[fsel]
    fnormal = cloud.normal[fsel]
    fimages = cloud.images[fsel]
    fgrids = cloud.grids[fsel]
    fdscale = cloud.dscale[fsel]
    ivalid = fimages >= 0
    radius = compute_radius(cams, cfg, fcoord, fnormal, fimages, ivalid)
    unit = patch_unit(cams, cfg, fcoord, fimages, ivalid)
    xdir, ydir = _ortho(fnormal)

    # neighbors: 3x3 cell window around each stored grid slot
    # (findNeighbors margin=1, scale=4)
    f = fsel.shape[0]
    t = cloud.max_views
    k = cfg.cell_k
    gx = fgrids[..., 0]
    gy = fgrids[..., 1]
    fills = jnp.zeros((f, 6))
    nb_radius = 1.5 * 1.0 * radius
    thr_n = thr.neighbor * 4.0

    # all 9 window offsets at once, kept flat [F, T*9] (a [F, T, 9]
    # intermediate would lane-pad 9 -> 128, grid.lookup_flat)
    offs = jnp.array([(-1, -1), (0, -1), (1, -1), (-1, 0), (0, 0), (1, 0),
                      (-1, 1), (0, 1), (1, 1)], jnp.int32)
    cx = jnp.repeat(gx, 9, axis=-1) + jnp.tile(offs[:, 0], t)[None]
    cy = jnp.repeat(gy, 9, axis=-1) + jnp.tile(offs[:, 1], t)[None]
    io = jnp.repeat(fimages, 9, axis=-1)
    ok9 = ((io >= 0) & (io < cfg.tn) & (cx >= 0) & (cx < cfg.gw)
           & (cy >= 0) & (cy < cfg.gh))
    key9 = (jnp.clip(io, 0, cfg.tn - 1) * cfg.gh
            + jnp.clip(cy, 0, cfg.gh - 1)) * cfg.gw \
        + jnp.clip(cx, 0, cfg.gw - 1)
    from .grid import is_neighbor_soa, soa_fields
    (cx_, cy_, cz_), (nx_, ny_, nz_), dq_ = soa_fields(cloud)
    fcx, fcy, fcz = fcoord[:, 0], fcoord[:, 1], fcoord[:, 2]
    fnx, fny, fnz = fnormal[:, 0], fnormal[:, 1], fnormal[:, 2]
    key = jnp.where(ok9, key9, tab.sentinel)
    pids, hit = tab.lookup_flat(key, k)                 # [F, T*9*K]
    hit = hit & jnp.repeat(ok9, k, axis=-1) & (pids >= 0)
    q = jnp.maximum(pids, 0)
    neigh = is_neighbor_soa(
        (fcx[:, None], fcy[:, None], fcz[:, None]),
        (fnx[:, None], fny[:, None], fnz[:, None]),
        fdscale[:, None], q, cx_, cy_, cz_, nx_, ny_, nz_, dq_,
        unit[:, None], thr_n, radius=nb_radius[:, None])
    m = hit & neigh & (q != fsel[:, None])
    dxq = cx_[q] - fcx[:, None]
    dyq = cy_[q] - fcy[:, None]
    dzq = cz_[q] - fcz[:, None]
    f2x = dxq * xdir[:, 0:1] + dyq * xdir[:, 1:2] + dzq * xdir[:, 2:3]
    f2y = dxq * ydir[:, 0:1] + dyq * ydir[:, 1:2] + dzq * ydir[:, 2:3]
    ln = jnp.sqrt(f2x * f2x + f2y * f2y)
    rl = radius[:, None]
    m = m & (ln >= rl / 6.0) & (ln <= rl * 2.5)
    ang = jnp.arctan2(f2y, f2x)
    ang = jnp.where(ang < 0.0, ang + 2 * jnp.pi, ang)
    findex = ang / (2 * jnp.pi / 6.0)
    lo = jnp.floor(findex).astype(jnp.int32)
    hi = lo + 1
    wlo = (hi - findex)
    whi = (findex - lo)
    flat = jnp.zeros((f, 7))
    pid_b = jnp.broadcast_to(jnp.arange(f)[:, None], m.shape)
    flat = flat.at[pid_b, jnp.where(m, lo % 6, 6)].add(
        jnp.where(m, wlo, 0.0))
    flat = flat.at[pid_b, jnp.where(m, hi % 6, 6)].add(
        jnp.where(m, whi, 0.0))
    fills = fills + flat[:, :6]

    sector = jnp.arange(6)
    fdflag = cloud.dflag[fsel]
    bit = (fdflag[:, None] >> sector[None]) & 1
    ok = (fills <= 0.0) & (bit == 0) & fok[:, None]
    ang = 2 * jnp.pi * sector / 6.0
    cand = (fcoord[:, None, :]
            + (jnp.cos(ang)[None, :, None] * xdir[:, None, :]
               + jnp.sin(ang)[None, :, None] * ydir[:, None, :])
            * radius[:, None, None])
    return cand, ok


import functools as _functools


class DiscoverResult(NamedTuple):
    """Gated, per-cell-deduped expansion candidates, best-score-first.

    Row order is (frontier score2 rank, sector), i.e. descending parent
    score2 - the same best-first order the reference's P_compare
    priority queue drains (expand.cpp:80-88). `ncand` (the number of
    True rows in `sval`) is the only value the host needs to read to
    size the commit batch."""

    coord: jax.Array      # [F6, 4] candidate centers
    normal: jax.Array     # [F6, 4] inherited normals
    vmask: jax.Array      # [F6, N] initial view masks
    ref: jax.Array        # [F6] reference image index
    parent: jax.Array     # [F6] parent row in the cloud slice
    sector: jax.Array     # [F6] direction bit index
    sval: jax.Array       # [F6] bool: candidate survives all gates
    overflow: jax.Array   # [P] frontier rows beyond fbudget (retry)
    ncand: jax.Array      # [] int32 = sval.sum()


@_functools.partial(jax.jit,
                    static_argnames=("cfg", "slack", "fbudget"))
def expand_discover(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                    thr: Thresholds, cloud: PatchCloud, grid: GridState,
                    frontier, slack: int, fbudget: int) -> DiscoverResult:
    """Wave stage 1 (cheap): frontier compaction, sector discovery, and
    every pre-refinement gate of expandSub (expand.cpp:108-180,
    200-256 up to the optimizer call).

    Split from the commit stage so the host can size the expensive
    refine batch to the REAL candidate count (`ncand`) instead of the
    worst-case 6x frontier: waves typically gate away 80-95% of sector
    proposals, and padding the refine kernel to the worst case was the
    dominant e2e overhead (BENCH_r02: 146 patches/s vs a 30k/s kernel).

    `slack`: checkCounts leniency, 0 on the first expand iteration and
    1 after (expand.cpp:276: depth-dependent minImageNum slack); passed
    statically instead of `depth` so iterations share compilations."""
    p = cloud.capacity
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)

    # ---- compact the frontier to [F], best score2 first ----
    score = cloud.score2(thr.ncc)
    NEG = jnp.float32(-jnp.inf)
    fscore = jnp.where(frontier & cloud.alive, score, NEG)
    fsel = jax.lax.top_k(fscore, fbudget)[1]                  # [F]
    fok = fscore[fsel] > NEG
    taken = jnp.zeros(p, bool).at[fsel].max(fok)
    overflow_frontier = frontier & cloud.alive & ~taken

    cand, cok = find_empty_blocks(cams, cfg, thr, cloud, tab,
                                  fsel, fok)                  # [F, 6]

    # flatten: row order (score rank, sector) is already best-first
    f6 = fbudget * 6
    sval = cok.reshape(-1)                                    # [F*6]
    coord = cand.reshape(-1, 4)
    parent = jnp.repeat(fsel, 6)
    sector = jnp.tile(jnp.arange(6, dtype=jnp.int32), fbudget)

    # --- expandSub gates (expand.cpp:200-256) ---
    # project into the parent's images (setGridsImages)
    pimgs = cloud.images[parent]                           # [F6, T]
    pval = pimgs >= 0
    ix, iy = cell_of(cams, cfg.level, cfg.csize, coord[:, None, :], pimgs)
    in_grid = (pval & (ix >= 0) & (ix < cfg.gw) & (iy >= 0)
               & (iy < cfg.gh))
    sval = sval & in_grid.any(axis=1)
    sval = sval & mask_all(pyr, cams.P, coord, cfg.level)
    # useBound gate (reference expand.cpp:212)
    from ..image.sample import inside_bimages
    sval = sval & inside_bimages(pyr, cams.P, coord, cfg.level,
                                 cfg.bindexes)

    # checkCounts (expand.cpp:258-323) over target-image cells
    tgt = in_grid & (pimgs < cfg.tn)
    ci = jnp.clip(pimgs, 0, cfg.tn - 1)
    cx = jnp.clip(ix, 0, cfg.gw - 1)
    cy = jnp.clip(iy, 0, cfg.gh - 1)
    occ_full = grid.occ[ci, cy, cx] > 0
    cnt_full = grid.counts[ci, cy, cx] >= thr.count1
    full = (tgt & (occ_full | cnt_full)).sum(axis=1)
    empty = (tgt & ~(occ_full | cnt_full)).sum(axis=1)
    sval = sval & ~((empty < cfg.min_image_num - slack) & (full != 0))

    # dedupe: one candidate per (ref image, cell) per wave; rows are
    # best-first so arange-priority keeps the best candidate per cell
    ref = jnp.maximum(pimgs[:, 0], 0)
    rix, riy = cell_of(cams, cfg.level, cfg.csize, coord, ref)
    ckey = (ref * cfg.gh + jnp.clip(riy, 0, cfg.gh - 1)) * cfg.gw \
        + jnp.clip(rix, 0, cfg.gw - 1)
    ckey = jnp.where(sval, ckey, cfg.tn * cfg.gh * cfg.gw)
    firstmap = jnp.full(cfg.tn * cfg.gh * cfg.gw + 1, f6, jnp.int32)
    firstmap = firstmap.at[ckey].min(jnp.arange(f6, dtype=jnp.int32))
    sval = sval & (firstmap[ckey] == jnp.arange(f6))

    # inherit normal; view mask = parent images that pass the edge map
    normal = cloud.normal[parent]
    vmask = jnp.zeros((f6, cfg.n), bool)
    vmask = vmask.at[jnp.arange(f6)[:, None],
                     jnp.maximum(pimgs, 0)].max(pval)
    vmask = V.remove_images_edge(pyr, cams, cfg.level, coord, vmask)
    sval = sval & vmask.any(axis=1)

    return DiscoverResult(coord=coord, normal=normal, vmask=vmask,
                          ref=ref, parent=parent, sector=sector,
                          sval=sval, overflow=overflow_frontier,
                          ncand=sval.sum().astype(jnp.int32))


@_functools.partial(jax.jit,
                    static_argnames=("cfg", "cbudget", "refine_iters"))
def expand_commit(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                  thr: Thresholds, visdata, cloud: PatchCloud,
                  grid: GridState, disc: DiscoverResult,
                  cbudget: int, refine_iters: int = 10):
    """Wave stage 2 (expensive): refine + postProcess the first
    `cbudget` surviving candidates (best-first), then commit successes
    to the cloud/grid. Candidates beyond `cbudget` put their parents
    back on the frontier for the next wave, exactly like the reference
    queue under contention. Returns (cloud, grid, new_frontier, stats).

    `disc.overflow` must be padded/sliced by the caller to this cloud's
    capacity. Runs process_candidates at depth=1 semantics (vimages
    enabled) - correct for every expansion iteration."""
    p = cloud.capacity
    f6 = disc.sval.shape[0]
    pos = jnp.nonzero(disc.sval, size=cbudget, fill_value=f6)[0]
    active = pos < f6
    posc = jnp.clip(pos, 0, f6 - 1)
    coord = disc.coord[posc]
    normal = disc.normal[posc]
    vmask = disc.vmask[posc] & active[:, None]
    ref = disc.ref[posc]
    parent = jnp.where(active, disc.parent[posc], p)
    sector = disc.sector[posc]

    # candidates not taken this wave requeue their parents
    taken = jnp.zeros(f6 + 1, bool).at[pos].set(True)[:f6]
    leftover = disc.sval & ~taken
    overflow_parent = jnp.zeros(p + 1, bool).at[
        jnp.where(leftover, disc.parent, p)].max(leftover)[:p]
    overflow_parent = overflow_parent | disc.overflow

    res = process_candidates_chunked(cams, pyr, cfg, thr, visdata,
                                     coord, normal, vmask, ref, depth=1,
                                     grid=grid, cloud=cloud,
                                     active=active,
                                     refine_iters=refine_iters)
    success = res.success & active
    sval = active

    # parent dflag |= bit on failure (expand.cpp:98-103). A (parent,
    # sector) pair occurs at most once per wave, so add == bitwise-or.
    fail = sval & ~success
    onehot = (1 << sector) * fail.astype(jnp.int32)
    dflag_updates = jnp.zeros(p + 1, jnp.int32).at[
        jnp.where(fail, parent, p)].add(onehot)
    new_dflag = cloud.dflag | dflag_updates[:p]
    cloud = replace(cloud, dflag=new_dflag)

    # updateCounts for successes (expand.cpp:325-406): bump every target
    # cell of images+vimages; requeue iff some cell was under threshold
    def bump(counts, images, grids, mask):
        im = images
        okc = (mask[:, None] & (im >= 0) & (im < cfg.tn)
               & (grids[..., 0] >= 0) & (grids[..., 0] < cfg.gw)
               & (grids[..., 1] >= 0) & (grids[..., 1] < cfg.gh))
        key = (jnp.clip(im, 0, cfg.tn - 1) * cfg.gh
               + jnp.clip(grids[..., 1], 0, cfg.gh - 1)) * cfg.gw \
            + jnp.clip(grids[..., 0], 0, cfg.gw - 1)
        key = jnp.where(okc, key, cfg.tn * cfg.gh * cfg.gw)
        under = grid.counts.reshape(-1)[jnp.clip(
            key, 0, cfg.tn * cfg.gh * cfg.gw - 1)] < thr.count1
        under = under & okc
        flat = jnp.zeros(cfg.tn * cfg.gh * cfg.gw + 1, jnp.int32)
        flat = flat.at[key].add(1)
        return flat[:-1].reshape(grid.counts.shape), under.any(axis=1)

    c1, under1 = bump(grid.counts, res.images, res.grids, success)
    c2, under2 = bump(grid.counts, res.vimages, res.vgrids, success)
    grid = replace(grid, counts=grid.counts + c1 + c2)
    requeue = success & (under1 | under2)

    # append successes; new frontier = the slots they landed in
    before = cloud.alive
    new = PatchCloud(
        coord=res.coord, normal=res.normal, ncc=res.ncc,
        images=res.images, grids=res.grids, vimages=res.vimages,
        vgrids=res.vgrids, timages=res.timages, dscale=res.dscale,
        ascale=res.ascale, dflag=jnp.zeros(cbudget, jnp.int32),
        alive=success)
    # requeue flag rides along: patches appended but not requeued leave
    # the frontier immediately
    cloud2, dropped = append_patches(cloud, new, success)
    appended = cloud2.alive & ~before
    # mark non-requeue patches: distribute `requeue` to landed slots by
    # order: appended slots are filled in index order matching the order
    # of success rows
    app_idx = jnp.nonzero(appended, size=cbudget, fill_value=p)[0]
    src_idx = jnp.nonzero(success, size=cbudget, fill_value=cbudget)[0]
    req = jnp.concatenate([requeue, jnp.zeros(1, bool)])[
        jnp.clip(src_idx, 0, cbudget)]
    new_frontier = jnp.zeros(p, bool).at[
        jnp.clip(app_idx, 0, p - 1)].max(
            req & (app_idx < p), mode="drop")
    new_frontier = new_frontier | (overflow_parent & cloud2.alive[:p])

    occ, vocc = rebuild_occupancy(cloud2, cfg.tn, cfg.gh, cfg.gw)
    dmin, didx = rebuild_depth_maps(cams, cloud2, cfg.level, cfg.csize,
                                    cfg.tn, cfg.gh, cfg.gw)
    grid = replace(grid, occ=occ, vocc=vocc, depth=dmin, depth_idx=didx)

    stats = WaveStats(candidates=sval.sum(),
                      accepted=success.sum(), dropped=dropped,
                      view_drops=res.view_drops)
    return cloud2, grid, new_frontier, stats


def expand_wave(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                thr: Thresholds, visdata, cloud: PatchCloud,
                grid: GridState, frontier, depth: int,
                budget: int, fbudget: int, refine_iters: int = 10):
    """One expansion wave = discover + commit at a fixed commit budget.

    Convenience wrapper for callers that do not host-size the commit
    batch (tests, the GSPMD equality harness); the engine calls the two
    stages separately so the refine batch can be sized to the measured
    candidate count."""
    slack = 0 if depth <= 1 else 1
    disc = expand_discover(cams, pyr, cfg, thr, cloud, grid, frontier,
                           slack, fbudget)
    return expand_commit(cams, pyr, cfg, thr, visdata, cloud, grid,
                         disc, budget, refine_iters=refine_iters)
