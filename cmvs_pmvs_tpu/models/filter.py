"""Outlier filtering as batched passes over the patch cloud.

Batched port of CFilter (reference source/pmvs/filter.cpp): the four
passes - outside-gain, exact visibility, quadric-fit neighborhood, small
connected components - run as dense masked computations using the
sort-based cell tables instead of per-cell shared_ptr lists.

Bounded-fan-out deviations (documented per pass): cell-mate queries cap at
cfg.cell_k entries per cell; filterNeighbor walks the 5x5 cell windows in
ALL stored images of a patch like the reference (findNeighbors,
patchOrganizerS.cpp:528-600; parity-tested in tests/test_filter_neighbor);
filterSmallGroups uses only the reference image as the reference does
(filter.cpp:614-665).
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom.cameras import CameraSet, get_unit
from .config import EngineConfig, Thresholds
from .expand import _ortho, compute_radius, patch_unit
from .grid import (
    CellTable, GridState, build_cell_table, is_neighbor, is_visible,
    rebuild_depth_maps, rebuild_occupancy,
)
from .patches import PatchCloud


def _pair_hunit(cams, cfg, cloud, q):
    """hunit for the 2-arg isNeighbor: mean of the two patches' reference
    1px units x csize (reference findMatch.cpp:120-123).

    Component-wise so gathers stay [P, M]-shaped (no 4-lane padding)."""
    p_ref = jnp.maximum(cloud.images[:, 0], 0)
    u_p = get_unit(cams, p_ref, cloud.coord, cfg.level)
    # per-patch unit of the candidates, gathered as a scalar field
    refs = jnp.maximum(cloud.images[:, 0], 0)
    unit_all = get_unit(cams, refs, cloud.coord, cfg.level)  # [P]
    u_q = unit_all[q]
    bshape = (slice(None),) + (None,) * (q.ndim - 1)
    return (u_p[bshape] + u_q) / 2.0 * cfg.csize


def _cell_lookup(cfg, tab: CellTable, images, grids, ox, oy):
    """Window lookup helper, K-folded: images/grids [P, M] ->
    (q patch ids [P, M*K], hit mask [P, M*K]); column m*K+j is the j-th
    occupant of slot m's cell (grid.lookup_flat keeps a size-K minor dim
    out of the gathered intermediates)."""
    cx = grids[..., 0] + ox
    cy = grids[..., 1] + oy
    ok = ((images >= 0) & (images < cfg.tn) & (cx >= 0) & (cx < cfg.gw)
          & (cy >= 0) & (cy < cfg.gh))
    key = (jnp.clip(images, 0, cfg.tn - 1) * cfg.gh
           + jnp.clip(cy, 0, cfg.gh - 1)) * cfg.gw \
        + jnp.clip(cx, 0, cfg.gw - 1)
    key = jnp.where(ok, key, tab.sentinel)
    pids, hit = tab.lookup_flat(key, cfg.cell_k)
    okk = jnp.repeat(ok, cfg.cell_k, axis=-1)
    return jnp.maximum(pids, 0), hit & okk & (pids >= 0)


def _solve5x5_spd(A, b):
    """Batched unrolled Cholesky solve for SPD [B, 5, 5] systems.

    jnp.linalg.solve lowers to a solver library call per batch (as the
    3x3 LM solve did before ops/refine._solve3x3 replaced it); an
    unrolled LL^T stays pure fusible elementwise math.
    Callers add a ridge so A is well-conditioned.
    """
    n = 5
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[:, j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
        for i in range(j + 1, n):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def filter_outside(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                   cloud: PatchCloud, grid: GridState) -> PatchCloud:
    """Kill patches with negative gain = score2 - sum of per-cell
    "pressure" from non-neighbor co-cell patches
    (reference filter.cpp:29-201)."""
    p = cloud.capacity
    ptab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, False)
    gain = cloud.score2(thr.ncc)
    from .grid import is_neighbor_soa, soa_fields
    (cx_, cy_, cz_), (nx_, ny_, nz_), dq_ = soa_fields(cloud)

    kk = cfg.cell_k

    def pressure(images, grids, depth_gate):
        q, hit = _cell_lookup(cfg, ptab, images, grids, 0, 0)  # [P, T*K]
        hunit = _pair_hunit(cams, cfg, cloud, q)
        neigh = is_neighbor_soa(
            (cx_[:, None], cy_[:, None], cz_[:, None]),
            (nx_[:, None], ny_[:, None], nz_[:, None]),
            cloud.dscale[:, None], q, cx_, cy_, cz_, nx_, ny_, nz_,
            dq_, hunit, thr.neighbor1)
        m = hit & ~neigh & (q != jnp.arange(p)[:, None]) \
            & cloud.alive[q]
        if depth_gate:
            # only co-cell patches *behind* this one press on it
            # (filter.cpp:117-144); optical-axis components gathered
            # separately - an [P, T, 4] gather would lane-pad 4 -> 128
            img = jnp.maximum(images, 0)
            a0 = cams.oaxis[img, 0]
            a1 = cams.oaxis[img, 1]
            a2 = cams.oaxis[img, 2]
            a3 = cams.oaxis[img, 3]
            pdepth = (a0 * cloud.coord[:, 0:1] + a1 * cloud.coord[:, 1:2]
                      + a2 * cloud.coord[:, 2:3]
                      + a3 * cloud.coord[:, 3:4])           # [P, T]
            rep = lambda x: jnp.repeat(x, kk, axis=-1)
            bdepth = (rep(a0) * cx_[q] + rep(a1) * cy_[q]
                      + rep(a2) * cz_[q] + rep(a3))
            m = m & (rep(pdepth) < bdepth)
        pres = jnp.where(m, cloud.ncc[q] - thr.ncc, 0.0)
        pres = jnp.maximum(pres, 0.0)
        # grouped max over each slot's K entries via strided slices
        # (a [P, T, K] reshape would re-materialize the padded layout)
        pmax = pres[:, 0::kk]
        for j in range(1, kk):
            pmax = jnp.maximum(pmax, pres[:, j::kk])        # [P, T]
        slot_ok = (images >= 0) & (images < cfg.tn)
        return jnp.where(slot_ok, pmax, 0.0).sum(axis=-1)

    gain = gain - pressure(cloud.images, cloud.grids, False)
    gain = gain - pressure(cloud.vimages, cloud.vgrids, True)
    kill = cloud.alive & (gain < 0.0)
    return replace(cloud, alive=cloud.alive & ~kill)


def filter_exact(cams: CameraSet, pyr, cfg: EngineConfig,
                 thr: Thresholds, cloud: PatchCloud,
                 grid: GridState) -> PatchCloud:
    """Per-image visibility re-check: a patch keeps an image only if it is
    depth-visible in that image's cell or a 4-neighbor cell; patches
    falling under min_image_num target images die, and the reference
    image is re-picked among the survivors by minimum summed pairwise
    INCC (reference filter.cpp:203-355 incl. the setRefImage re-pick at
    :277-281)."""
    imgs = cloud.images
    ok_slot = (imgs >= 0) & (imgs < cfg.tn)
    checks = []
    for ox, oy in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
        checks.append(is_visible(
            cams, cloud, grid, cfg.level, cfg.csize,
            cloud.coord[:, None, :], cloud.normal[:, None, :],
            jnp.maximum(imgs, 0), cloud.grids[..., 0] + ox,
            cloud.grids[..., 1] + oy, thr.neighbor1))
    safe = jnp.stack(checks).any(axis=0)
    keep_slot = jnp.where(ok_slot, safe, imgs >= 0)   # non-targets stay
    new_imgs = jnp.where(keep_slot, imgs, -1)
    tcount = (keep_slot & ok_slot).sum(axis=1)
    alive = cloud.alive & (tcount + ((imgs >= cfg.tn) & keep_slot).sum(
        axis=1) >= cfg.min_image_num) & (tcount > 0)
    # compact: surviving target slots first (new slot 0 = a target view;
    # the reference re-runs setRefImage here, filter.cpp:277-281 - slot
    # order is a cheaper stand-in, re-scored at the next constraint pass)
    rank = jnp.where(keep_slot & ok_slot, 0, jnp.where(keep_slot, 1, 2))
    order = jnp.argsort(rank, axis=1, stable=True)
    new_imgs = jnp.take_along_axis(new_imgs, order, axis=1)
    new_grids = jnp.take_along_axis(cloud.grids, order[..., None], axis=1)

    # re-pick the reference among survivors (filter.cpp:277-281): the
    # target view minimizing the summed pairwise robust INCC
    from . import views as V
    pcap = new_imgs.shape[0]
    vmask = jnp.zeros((pcap, cfg.n), bool)
    vmask = vmask.at[jnp.arange(pcap)[:, None],
                     jnp.maximum(new_imgs, 0)].max(new_imgs >= 0)
    old_ref = jnp.maximum(new_imgs[:, 0], 0)
    new_ref, ref_ok = V.set_ref_image(cams, pyr, cfg.level, cfg.wsize,
                                      cfg.tn, cloud.coord, cloud.normal,
                                      old_ref, vmask)
    # swap the chosen reference into slot 0
    hit = new_imgs == new_ref[:, None]
    slot = jnp.argmax(hit, axis=1)
    do = alive & ref_ok & hit.any(axis=1) & (slot != 0)
    rows = jnp.arange(pcap)
    s0_img = new_imgs[:, 0]
    s0_grid = new_grids[:, 0]
    sw_img = new_imgs[rows, slot]
    sw_grid = new_grids[rows, slot]
    new_imgs = new_imgs.at[rows, slot].set(
        jnp.where(do, s0_img, sw_img))
    new_imgs = new_imgs.at[:, 0].set(jnp.where(do, sw_img, s0_img))
    new_grids = new_grids.at[rows, slot].set(
        jnp.where(do[:, None], s0_grid, sw_grid))
    new_grids = new_grids.at[:, 0].set(
        jnp.where(do[:, None], sw_grid, s0_grid))
    return replace(cloud, images=new_imgs, grids=new_grids,
                   timages=tcount.astype(jnp.int32),
                   alive=alive)


# Device-memory clamp for the filterNeighbor pair pass: each live pair
# carries its R and Q packs, scatter columns and tangent/moment temps.
# At 16 MiPairs XLA's memory_analysis on an H100 reports 0.68 GiB of
# temporaries for one pass with a 200k cloud (PERF.md), a small share
# of the card beside the cloud + pyramids; denser clouds run the pass
# in row chunks (filter_neighbor_chunked) with identical per-patch
# decisions.
MAX_PAIRS_PER_PASS = 16 << 20


def _neighbor_query_keys(cfg: EngineConfig, cloud: PatchCloud,
                         sentinel: int):
    """filterNeighbor's query cells: the 5x5 window around the patch's
    cell in every stored target-image slot, [P, T*25] flat keys + mask."""
    offs = jnp.array([(ox, oy) for oy in range(-2, 3)
                      for ox in range(-2, 3)], jnp.int32)
    t = cloud.max_views
    cx = jnp.repeat(cloud.grids[..., 0], 25, axis=-1) \
        + jnp.tile(offs[:, 0], t)[None]
    cy = jnp.repeat(cloud.grids[..., 1], 25, axis=-1) \
        + jnp.tile(offs[:, 1], t)[None]
    io = jnp.repeat(cloud.images, 25, axis=-1)
    oko = ((io >= 0) & (io < cfg.tn) & (cx >= 0) & (cx < cfg.gw)
           & (cy >= 0) & (cy < cfg.gh)) & cloud.alive[:, None]
    key = (jnp.clip(io, 0, cfg.tn - 1) * cfg.gh
           + jnp.clip(cy, 0, cfg.gh - 1)) * cfg.gw \
        + jnp.clip(cx, 0, cfg.gw - 1)
    return jnp.where(oko, key, sentinel), oko


def filter_neighbor(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                    cloud: PatchCloud, grid: GridState,
                    pair_budget: int) -> tuple[PatchCloud, jax.Array]:
    """Reject patches with < 6 coplanar neighbors or a bad quadric fit
    (reference filter.cpp:357-462 filterNeighbor + filterQuad).

    Neighbors are gathered from the 5x5 cell windows around the patch's
    cell in EVERY stored target image (reference findNeighbors walks all
    of patch._images with skipvis=1, gathering each cell's pgrids AND
    vpgrids occupants, patchOrganizerS.cpp:528-600; duplicates across
    windows are kept and the patch itself is NOT excluded - zero-offset
    self rows count toward nsize exactly as the reference's do).

    Structured as ONE compacted pair pass (grid.window_pairs): the
    reference's three walks over the neighbor list (h, normal
    equations, residual) become per-pair raw moments - the quad design
    scales as fx = gx/h, so every normal-equation entry is a raw moment
    of (gx, gy, fz) times a power of the per-patch scale, and only the
    residual pass re-reads the stored per-pair values. The dense
    [P, T*25*K] fan-out this replaces was ~98% padding and made this
    pass 82% of the whole filter stage on-chip. Returns
    (cloud, dropped-pair count) - the caller must surface overflow.
    """
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    reject, dropped = _filter_neighbor_core(cams, cfg, thr, cloud, cloud,
                                            tab, pair_budget)
    return replace(cloud, alive=cloud.alive & ~reject), dropped


def _filter_neighbor_core(cams: CameraSet, cfg: EngineConfig,
                          thr: Thresholds, qcloud: PatchCloud,
                          cloud: PatchCloud, tab: CellTable,
                          pair_budget: int):
    """filterNeighbor decisions for the query rows `qcloud` (any row
    slice of `cloud`; per-patch decisions are independent, so chunked
    row slices give bit-identical verdicts to one full pass). Neighbor
    occupants come from `tab`, built over the FULL cloud. Returns
    (reject [PQ] bool, dropped pair count)."""
    p = qcloud.capacity

    ivalid = qcloud.images >= 0
    radius = 1.5 * 2.0 * compute_radius(cams, cfg, qcloud.coord,
                                        qcloud.normal, qcloud.images,
                                        ivalid)
    unit_n = patch_unit(cams, cfg, qcloud.coord, qcloud.images, ivalid)
    thr_n = thr.neighbor * 4.0
    xdir, ydir = _ortho(qcloud.normal)

    from .grid import is_neighbor_comp, window_pairs

    key, oko = _neighbor_query_keys(cfg, qcloud, tab.sentinel)
    rows, eidx, pval, dropped = window_pairs(tab, key, oko, pair_budget,
                                             cfg.cell_k)
    q = tab.pid[eidx]                                        # [PB]

    # ONE packed gather per pair side: the per-component [PB] gathers
    # this replaces cost ~8.7 ms EACH on-chip at bench pair counts
    # (XLA picks slow layouts for narrow gather sources), and this pass
    # needs ~17 of them; gather width is nearly free by comparison.
    rnorm = jnp.maximum(radius, 1e-30)
    rowpack = jnp.concatenate([
        qcloud.coord[:, :3], qcloud.normal[:, :3],
        qcloud.dscale[:, None], unit_n[:, None], rnorm[:, None],
        radius[:, None], xdir[:, :3], ydir[:, :3]], axis=1)  # [P, 16]
    R = rowpack[rows]                                        # [PB, 16]
    qpack = jnp.concatenate([
        cloud.coord[:, :3], cloud.normal[:, :3],
        cloud.dscale[:, None]], axis=1)                      # [P, 7]
    Q = qpack[q]                                             # [PB, 7]

    # per-pair neighbor predicate (isNeighborRadius)
    neigh = is_neighbor_comp(
        (R[:, 0], R[:, 1], R[:, 2]), (R[:, 3], R[:, 4], R[:, 5]),
        R[:, 6], (Q[:, 0], Q[:, 1], Q[:, 2]),
        (Q[:, 3], Q[:, 4], Q[:, 5]), Q[:, 6],
        R[:, 7], thr_n, radius=R[:, 9])
    m = pval & neigh
    mrow = jnp.where(m, rows, p)                 # scatter target (+drop)
    mf = m.astype(jnp.float32)

    dxq = Q[:, 0] - R[:, 0]
    dyq = Q[:, 1] - R[:, 1]
    dzq = Q[:, 2] - R[:, 2]

    # raw tangent-frame coordinates, normalized by the (pre-known)
    # gather radius so 4th-order moments stay O(1) in f32
    rr = R[:, 8]

    gx = (dxq * R[:, 10] + dyq * R[:, 11] + dzq * R[:, 12]) / rr
    gy = (dxq * R[:, 13] + dyq * R[:, 14] + dzq * R[:, 15]) / rr
    fz = (dxq * R[:, 3] + dyq * R[:, 4] + dzq * R[:, 5])  # reference b

    # normal equations as raw moments: design col i = s^{deg_i} *
    # gx^{a_i} gy^{b_i} with s = radius/h, so ATA_ij =
    # M[a_i+a_j, b_i+b_j] * s^{deg_i+deg_j} and ATb_i = Mz[a_i,b_i] *
    # s^{deg_i} (filter.cpp:409-431 computes the same values
    # neighbor-by-neighbor). All per-pair accumulations - the count and
    # h-sum (filter.cpp:403-407), 12 unique M moments and 5 Mz moments -
    # go through ONE multi-column scatter: separate scatter-adds cost
    # ~8.7 ms each on-chip at bench pair counts, one [PB, 19] scatter
    # costs one.
    d = jnp.sqrt(dxq * dxq + dyq * dyq + dzq * dzq)
    exps = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1))
    gxp = {0: jnp.ones_like(gx), 1: gx, 2: gx * gx}
    gyp = {0: jnp.ones_like(gy), 1: gy, 2: gy * gy}
    cols = [jnp.where(m, 1.0, 0.0), jnp.where(m, d, 0.0)]
    mkeys = []
    for (a1, b1) in exps:
        cols.append(mf * gxp[a1] * gyp[b1] * fz)        # Mz[(a1, b1)]
        for (a2, b2) in exps:
            a, bb = a1 + a2, b1 + b2
            if (a, bb) not in mkeys:
                ga = gx ** a if a > 2 else gxp[a]
                gb = gy ** bb if bb > 2 else gyp[bb]
                mkeys.append((a, bb))
                cols.append(mf * ga * gb)
    S = jnp.zeros((p + 1, len(cols))).at[mrow].add(
        jnp.stack(cols, axis=-1))[:p]
    cnt = S[:, 0].astype(jnp.int32)
    h = S[:, 1] / jnp.maximum(cnt, 1)
    h = jnp.where(h == 0.0, 1.0, h)
    M = {}
    Mz = {}
    ci = 2
    for (a1, b1) in exps:
        Mz[(a1, b1)] = S[:, ci]
        ci += 1
        for (a2, b2) in exps:
            a, bb = a1 + a2, b1 + b2
            if (a, bb) not in M:
                M[(a, bb)] = S[:, ci]
                ci += 1
    s = rnorm / h                                # [P]
    deg = [2, 2, 2, 1, 1]
    ata = jnp.stack([
        jnp.stack([M[(exps[i][0] + exps[j][0], exps[i][1] + exps[j][1])]
                   * s ** (deg[i] + deg[j]) for j in range(5)], axis=-1)
        for i in range(5)], axis=-2)
    atb = jnp.stack([Mz[exps[i]] * s ** deg[i] for i in range(5)],
                    axis=-1)
    x = _solve5x5_spd(ata + 1e-9 * jnp.eye(5)[None], atb)

    # residual pass (filter.cpp:443-455) over the same stored pairs;
    # quad coefficients + s packed into one gather like the fields above
    xs = jnp.concatenate([x, s[:, None]], axis=1)[rows]      # [PB, 6]
    sr = xs[:, 5]
    fx = gx * sr
    fy = gy * sr
    pred = (xs[:, 0] * fx * fx + xs[:, 1] * fy * fy
            + xs[:, 2] * fx * fy + xs[:, 3] * fx + xs[:, 4] * fy)
    res_sum = jnp.zeros(p + 1).at[mrow].add(
        jnp.where(m, jnp.abs(pred - fz), 0.0))[:p]

    inum = jnp.minimum(cfg.tau, (qcloud.images >= 0).sum(axis=1))
    u = get_unit(cams, jnp.maximum(qcloud.images, 0),
                 qcloud.coord[:, None, :], cfg.level)
    u = jnp.where(qcloud.images >= 0, u, 0.0)
    u = u[:, :cfg.tau].sum(axis=1) / jnp.maximum(inum, 1)
    residual = res_sum / jnp.where(u == 0.0, 1.0, u) \
        / jnp.maximum(cnt - 5, 1)

    reject = (cnt < 6) | (residual >= thr.quad)
    return reject & qcloud.alive, dropped


def filter_small_groups(cams: CameraSet, cfg: EngineConfig,
                        thr: Thresholds, cloud: PatchCloud,
                        grid: GridState, prop_iters: int = 24
                        ) -> PatchCloud:
    """Remove connected components smaller than max(20, P/10000)
    (reference filter.cpp:524-665): components over the "isNeighbor via
    3x3 reference-image cells" graph, found by min-label propagation with
    pointer jumping."""
    p = cloud.capacity
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    ref_imgs = cloud.images[:, 0:1]
    ref_grids = cloud.grids[:, 0:1]

    # static neighbor structure: [P, 9*K] candidate ids + mask over the
    # merged pgrids+vpgrids table, window offsets kept flat [P, 9]
    offs = jnp.array([(ox, oy) for oy in (-1, 0, 1)
                      for ox in (-1, 0, 1)], jnp.int32)
    cx = ref_grids[:, 0, 0:1] + offs[None, :, 0]                # [P, 9]
    cy = ref_grids[:, 0, 1:2] + offs[None, :, 1]
    io = ref_imgs
    oko = ((io >= 0) & (io < cfg.tn) & (cx >= 0) & (cx < cfg.gw)
           & (cy >= 0) & (cy < cfg.gh))
    keyo = (jnp.clip(io, 0, cfg.tn - 1) * cfg.gh
            + jnp.clip(cy, 0, cfg.gh - 1)) * cfg.gw \
        + jnp.clip(cx, 0, cfg.gw - 1)
    from .grid import is_neighbor_soa, soa_fields
    (cx_, cy_, cz_), (nx_, ny_, nz_), dq_ = soa_fields(cloud)
    key = jnp.where(oko, keyo, tab.sentinel)
    pids, hit = tab.lookup_flat(key, cfg.cell_k)  # [P, 9*K]
    qn = jnp.maximum(pids, 0)
    hit = hit & jnp.repeat(oko, cfg.cell_k, axis=-1) & (pids >= 0)
    hunit = _pair_hunit(cams, cfg, cloud, qn)
    neigh = is_neighbor_soa(
        (cx_[:, None], cy_[:, None], cz_[:, None]),
        (nx_[:, None], ny_[:, None], nz_[:, None]),
        cloud.dscale[:, None], qn, cx_, cy_, cz_, nx_, ny_, nz_, dq_,
        hunit, thr.neighbor2)
    mn = hit & neigh & cloud.alive[qn] & cloud.alive[:, None]

    label = jnp.where(cloud.alive, jnp.arange(p), p)

    def cond(state):
        i, _, changed = state
        return (i < prop_iters) & changed

    def body(state):
        i, lbl, _ = state
        nl = jnp.where(mn, lbl[qn], p).min(axis=1)
        nl = jnp.minimum(lbl, nl)
        # pointer jumping
        nl = jnp.minimum(nl, jnp.concatenate([nl, jnp.array([p])])[nl])
        return i + 1, nl, jnp.any(nl != lbl)

    _, label, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), label, jnp.bool_(True)))

    sizes = jnp.zeros(p + 1, jnp.int32).at[label].add(
        cloud.alive.astype(jnp.int32))
    psize = cloud.alive.sum()
    threshold = jnp.maximum(20, psize // 10000)
    small = sizes[label] < threshold
    return replace(cloud, alive=cloud.alive & ~small)


import functools as _ft


@_ft.partial(jax.jit, static_argnames=("cfg",))
def refresh_visibility(cams: CameraSet, pyr, cfg: EngineConfig,
                       thr: Thresholds, cloud: PatchCloud,
                       grid: GridState) -> tuple[PatchCloud, GridState]:
    """Rebuild depth maps, vimages/vgrids and occupancy for the whole
    cloud (reference setDepthMapsVGridsVPGridsAddPatchV,
    filter.cpp:734-783; always the non-additive variant)."""
    occ, vocc = rebuild_occupancy(cloud, cfg.tn, cfg.gh, cfg.gw)
    dmin, didx = rebuild_depth_maps(cams, cloud, cfg.level, cfg.csize,
                                    cfg.tn, cfg.gh, cfg.gw)
    grid = replace(grid, occ=occ, depth=dmin, depth_idx=didx)

    from .process import set_vimages
    vimages, vgrids = set_vimages(
        cams, pyr, cfg, thr, grid, cloud, cloud.coord, cloud.normal,
        cloud.images, cloud.images >= 0, cloud.max_views)
    vimages = jnp.where(cloud.alive[:, None], vimages, -1)
    cloud = replace(cloud, vimages=vimages, vgrids=vgrids)

    occ, vocc = rebuild_occupancy(cloud, cfg.tn, cfg.gh, cfg.gw)
    grid = replace(grid, occ=occ, vocc=vocc)
    return cloud, grid


import functools as _functools


@_functools.partial(jax.jit, static_argnames=("cfg",))
def run_filters_pre(cams: CameraSet, pyr, cfg: EngineConfig,
                    thr: Thresholds, cloud: PatchCloud, grid: GridState
                    ) -> tuple[PatchCloud, GridState, dict]:
    """Filter stage part 1: filterOutside + filterExact with their
    visibility rebuilds (reference CFilter::run, filter.cpp:13-21)."""
    stats = {}
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)
    n0 = cloud.count()

    cloud = filter_outside(cams, cfg, thr, cloud, grid)
    stats["outside"] = (n0, cloud.count())
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)

    n1 = cloud.count()
    cloud = filter_exact(cams, pyr, cfg, thr, cloud, grid)
    stats["exact"] = (n1, cloud.count())
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)
    return cloud, grid, stats


@_functools.partial(jax.jit, static_argnames=("cfg",))
def count_neighbor_pairs(cfg: EngineConfig, cloud: PatchCloud):
    """Exact filterNeighbor pair count on the current state - the host
    reads this one scalar to size run_filters_post's pair budget (no
    blind budget + retry)."""
    from .grid import count_window_pairs
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    key, oko = _neighbor_query_keys(cfg, cloud, tab.sentinel)
    return count_window_pairs(tab, key, oko, cfg.cell_k)


@_functools.partial(jax.jit, static_argnames=("cfg", "pc"))
def count_neighbor_pairs_rows(cfg: EngineConfig, cloud: PatchCloud,
                              row0, *, pc: int):
    """Exact pair count for query rows [row0, row0 + pc)."""
    from .grid import count_window_pairs
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    qcloud = jax.tree.map(
        lambda a: jax.lax.dynamic_slice_in_dim(a, row0, pc, 0), cloud)
    key, oko = _neighbor_query_keys(cfg, qcloud, tab.sentinel)
    return count_window_pairs(tab, key, oko, cfg.cell_k)


@_functools.partial(jax.jit,
                    static_argnames=("cfg", "pc", "pair_budget"))
def filter_neighbor_rows(cams: CameraSet, cfg: EngineConfig,
                         thr: Thresholds, cloud: PatchCloud, row0, *,
                         pc: int, pair_budget: int):
    """filterNeighbor verdicts for query rows [row0, row0 + pc) against
    the full cloud's cell table. Returns (reject [pc], dropped)."""
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    qcloud = jax.tree.map(
        lambda a: jax.lax.dynamic_slice_in_dim(a, row0, pc, 0), cloud)
    return _filter_neighbor_core(cams, cfg, thr, qcloud, cloud, tab,
                                 pair_budget)


def filter_neighbor_chunked(cams: CameraSet, cfg: EngineConfig,
                            thr: Thresholds, cloud: PatchCloud,
                            total_pairs: int,
                            max_pairs: int = MAX_PAIRS_PER_PASS):
    """Host orchestrator: run filterNeighbor in row chunks so no single
    pass materializes more than ~max_pairs pairs (VERDICT r3 weak 7 -
    the single-pass budget is unbounded in pair count but each pair
    costs ~300 B of transient HBM). Per-patch decisions are independent,
    so the union of chunk verdicts equals the single-pass result
    exactly. Returns (cloud, dropped)."""
    import numpy as np
    from .engine import _bucket15
    p = cloud.capacity
    # target half the budget per chunk: row chunks are uniform but pair
    # density is not, so leave skew headroom
    nchunk = max(2, -(-total_pairs // max(max_pairs // 2, 1)))
    pc0 = min(p, _bucket15(-(-p // nchunk), p))
    pc = pc0
    reject = np.zeros(p, bool)
    dropped = 0
    row0 = 0
    while row0 < p:
        start = min(row0, p - pc)
        cnt = int(count_neighbor_pairs_rows(cfg, cloud, start, pc=pc))
        if cnt > max_pairs and pc > 1024:
            # a spatially dense region concentrated more pairs in this
            # row span than the HBM clamp allows: halve the span and
            # retry (verdicts are row-independent, so any split is
            # exact). The bucketed sizes bound recompiles to O(log p).
            pc = max(1024, _bucket15(pc // 2, p))
            continue
        pb = _bucket15(max(cnt, 1024), 1 << 62)
        rej, dr = filter_neighbor_rows(cams, cfg, thr, cloud, start,
                                       pc=pc, pair_budget=pb)
        reject[start:start + pc] = np.asarray(rej)
        dropped += int(dr)
        row0 = start + pc
        # grow back toward the target span after a dense region
        pc = min(pc0, _bucket15(pc * 2, p)) if pc < pc0 else pc0
    alive = cloud.alive & ~jnp.asarray(reject)
    return replace(cloud, alive=alive), dropped


@_functools.partial(jax.jit, static_argnames=("cfg",))
def run_filters_tail(cams: CameraSet, pyr, cfg: EngineConfig,
                     thr: Thresholds, cloud: PatchCloud, grid: GridState
                     ) -> tuple[PatchCloud, GridState, dict]:
    """Filter stage part 2b: the passes after filterNeighbor (visibility
    rebuild + filterSmallGroups + rebuild) - used when the neighbor pass
    ran chunked outside the run_filters_post program."""
    stats = {}
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)
    n3 = cloud.count()
    cloud = filter_small_groups(cams, cfg, thr, cloud, grid)
    stats["groups"] = (n3, cloud.count())
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)
    return cloud, grid, stats


@_functools.partial(jax.jit, static_argnames=("cfg", "pair_budget"))
def run_filters_post(cams: CameraSet, pyr, cfg: EngineConfig,
                     thr: Thresholds, cloud: PatchCloud, grid: GridState,
                     pair_budget: int
                     ) -> tuple[PatchCloud, GridState, dict]:
    """Filter stage part 2: filterNeighbor + filterSmallGroups with
    their visibility rebuilds (filter.cpp:22-27). `pair_budget` should
    come from count_neighbor_pairs; stats still carry the dropped count
    as a guard."""
    stats = {}
    n2 = cloud.count()
    cloud, pairs_dropped = filter_neighbor(cams, cfg, thr, cloud, grid,
                                           pair_budget)
    stats["neighbor"] = (n2, cloud.count())
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)

    n3 = cloud.count()
    cloud = filter_small_groups(cams, cfg, thr, cloud, grid)
    stats["groups"] = (n3, cloud.count())
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)
    stats["pairs_dropped"] = (pairs_dropped, pairs_dropped)
    return cloud, grid, stats


def run_filters(cams: CameraSet, pyr, cfg: EngineConfig, thr: Thresholds,
                cloud: PatchCloud, grid: GridState,
                pair_budget: int = 0
                ) -> tuple[PatchCloud, GridState, dict]:
    """The full filter stage (reference CFilter::run, filter.cpp:13-27).

    Convenience wrapper: runs pre, sizes the neighbor pair budget from
    the exact count (unless `pair_budget` forces one), then post. The
    engine calls the stages itself to control bucketing."""
    cloud, grid, stats = run_filters_pre(cams, pyr, cfg, thr, cloud, grid)
    if pair_budget <= 0:
        need = int(count_neighbor_pairs(cfg, cloud))
        if need > MAX_PAIRS_PER_PASS:
            n0 = int(cloud.count())
            cloud, dropped = filter_neighbor_chunked(cams, cfg, thr,
                                                     cloud, need)
            stats["neighbor"] = (n0, int(cloud.count()))
            cloud, grid, stats2 = run_filters_tail(cams, pyr, cfg, thr,
                                                   cloud, grid)
            stats.update(stats2)
            stats["pairs_dropped"] = (dropped, dropped)
            return cloud, grid, stats
        pair_budget = max(1024, 1 << (need - 1).bit_length())
    cloud, grid, stats2 = run_filters_post(cams, pyr, cfg, thr, cloud,
                                           grid, pair_budget)
    stats.update(stats2)
    return cloud, grid, stats
