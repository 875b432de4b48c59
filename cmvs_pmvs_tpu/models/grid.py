"""Cell-grid state: occupancy, attempt counters, depth maps, neighbors.

Batched replacement for CPatchOrganizerS's per-cell shared_ptr lists and
locks (reference source/pmvs/patchOrganizerS.cpp): dense [TN, GH, GW]
tensors maintained by scatter ops, plus a sort-based cell membership table
that gives each patch bounded access to its cell-mates (the reference walks
std::vector<PPatch> per cell; we cap at K entries per cell window).

All "image" indices here are engine indexes; only target images (< tn)
carry grids (patchOrganizerS.cpp:73-86).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from ..geom.cameras import HIGHEST, CameraSet, get_unit, project
from .patches import PatchCloud

INF = jnp.inf


def cell_of(cams: CameraSet, level: int, csize: int, coord, images):
    """Project and quantize to cells: ix = floor(x + 0.5) / csize
    (reference patchOrganizerS.cpp:405-414 setGrids).

    coord: [..., 4]; images: [...] int32 (clamped for gathers). coord's
    batch either matches images exactly or carries a broadcast slot
    axis ([..., 1, 4] against images [..., T]). Returns (ix, iy) int32.

    Implementation note: projections run against ALL cameras as one
    [.., 4] x [4, N*3] matmul and the per-slot rows are then selected
    by a flat gather. Gathering P per slot instead (`cams.P[vid]`)
    materializes a [B, T, 3, 4] tensor per call, 12x the coordinates'
    size at full-scene expand_discover batches.
    """
    from ..geom.cameras import PROJ_SENTINEL, level_projection
    vid = jnp.maximum(images, 0)
    n = cams.num
    Pf = level_projection(cams.P, level).reshape(n * 3, 4).T  # [4, N*3]
    offs = jnp.arange(3, dtype=jnp.int32)
    if coord.shape[:-1] == images.shape:
        base = jnp.matmul(coord, Pf, precision=HIGHEST)      # [..., N*3]
        idx = vid[..., None] * 3 + offs
        q = jnp.take_along_axis(base, idx, axis=-1)           # [..., 3]
    else:
        assert coord.shape[:-2] == images.shape[:-1] \
            and coord.shape[-2] == 1, (coord.shape, images.shape)
        base = jnp.matmul(coord[..., 0, :], Pf,
                          precision=HIGHEST)                # [..., N*3]
        t = images.shape[-1]
        idx = (vid[..., None] * 3 + offs).reshape(
            images.shape[:-1] + (t * 3,))
        q = jnp.take_along_axis(base, idx, axis=-1).reshape(
            images.shape + (3,))
    z = q[..., 2]
    bad = z <= 0.0
    zsafe = jnp.where(bad, 1.0, z)
    x = jnp.where(bad, PROJ_SENTINEL,
                  jnp.clip(q[..., 0] / zsafe, -1.0e9, 1.0e9))
    y = jnp.where(bad, PROJ_SENTINEL,
                  jnp.clip(q[..., 1] / zsafe, -1.0e9, 1.0e9))
    ix = jnp.floor(x + 0.5).astype(jnp.int32) // csize
    iy = jnp.floor(y + 0.5).astype(jnp.int32) // csize
    return ix, iy


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GridState:
    """Dense per-cell aggregates over target images."""

    counts: jax.Array      # [TN, GH, GW] i32 attempt counters
    occ: jax.Array         # [TN, GH, GW] i32 number of patches (pgrids)
    vocc: jax.Array        # [TN, GH, GW] i32 number of v-patches (vpgrids)
    depth: jax.Array       # [TN, GH, GW] f32 front-most optical-axis depth
    depth_idx: jax.Array   # [TN, GH, GW] i32 patch index of front-most

    @property
    def shape(self):
        return self.counts.shape


def empty_grid(tn: int, gh: int, gw: int) -> GridState:
    return GridState(
        counts=jnp.zeros((tn, gh, gw), jnp.int32),
        occ=jnp.zeros((tn, gh, gw), jnp.int32),
        vocc=jnp.zeros((tn, gh, gw), jnp.int32),
        depth=jnp.full((tn, gh, gw), INF),
        depth_idx=jnp.full((tn, gh, gw), -1, jnp.int32),
    )


def _flat_cells(images, grids, tn: int, gh: int, gw: int):
    """Flat cell keys for (patch, slot) pairs; invalid -> tn*gh*gw."""
    ix = grids[..., 0]
    iy = grids[..., 1]
    valid = ((images >= 0) & (images < tn) & (ix >= 0) & (ix < gw)
             & (iy >= 0) & (iy < gh))
    key = (jnp.clip(images, 0, tn - 1) * gh
           + jnp.clip(iy, 0, gh - 1)) * gw + jnp.clip(ix, 0, gw - 1)
    return jnp.where(valid, key, tn * gh * gw), valid


def rebuild_occupancy(cloud: PatchCloud, tn: int, gh: int,
                      gw: int) -> tuple[jax.Array, jax.Array]:
    """(occ, vocc) scatter-adds over alive patches' grids/vgrids."""
    def scat(images, grids):
        key, valid = _flat_cells(images, grids, tn, gh, gw)
        m = valid & cloud.alive[:, None]
        flat = jnp.zeros(tn * gh * gw + 1, jnp.int32)
        flat = flat.at[jnp.where(m, key, tn * gh * gw)].add(1)
        return flat[:-1].reshape(tn, gh, gw)

    return scat(cloud.images, cloud.grids), scat(cloud.vimages, cloud.vgrids)


def rebuild_depth_maps(cams: CameraSet, cloud: PatchCloud, level: int,
                       csize: int, tn: int, gh: int, gw: int):
    """Front-most patch per cell by optical-axis depth, scattered into the
    4 cells around the projection (reference updateDepthMaps
    patchOrganizerS.cpp:351-381 / setDepthMaps filter.cpp:667-732).

    Returns (depth [TN, GH, GW], depth_idx [TN, GH, GW]).
    """
    p = cloud.capacity
    # project every alive patch into every target image
    tgt = jnp.arange(tn)
    ic = project(cams.P[tgt][None], cloud.coord[:, None, :], level)
    fx = ic[..., 0] / csize                          # [P, TN]
    fy = ic[..., 1] / csize
    depth = jnp.einsum("tk,pk->pt", cams.oaxis[tgt], cloud.coord,
                       precision=HIGHEST)
    behind = ic[..., 2] < 0.0

    # floor/ceil kept as separate [P, TN] arrays (a stacked [P, TN, 2]
    # would lane-pad 2 -> 128 at capacity, see CellTable.lookup_flat)
    xs = (jnp.floor(fx).astype(jnp.int32), jnp.ceil(fx).astype(jnp.int32))
    ys = (jnp.floor(fy).astype(jnp.int32), jnp.ceil(fy).astype(jnp.int32))

    flat_d = jnp.full(tn * gh * gw + 1, INF)
    flat_i = jnp.full(tn * gh * gw + 1, jnp.iinfo(jnp.int32).max, jnp.int32)
    pid = jnp.arange(p, dtype=jnp.int32)
    for j in range(2):
        for i in range(2):
            x = xs[i]
            y = ys[j]
            ok = (cloud.alive[:, None] & ~behind & (x >= 0) & (x < gw)
                  & (y >= 0) & (y < gh))
            key = (tgt[None] * gh + jnp.clip(y, 0, gh - 1)) * gw \
                + jnp.clip(x, 0, gw - 1)
            key = jnp.where(ok, key, tn * gh * gw)
            flat_d = flat_d.at[key].min(jnp.where(ok, depth, INF))
            # tie-break by smallest patch index at the minimal depth
    dmin = flat_d[:-1].reshape(tn, gh, gw)
    for j in range(2):
        for i in range(2):
            x = xs[i]
            y = ys[j]
            ok = (cloud.alive[:, None] & ~behind & (x >= 0) & (x < gw)
                  & (y >= 0) & (y < gh))
            key = (tgt[None] * gh + jnp.clip(y, 0, gh - 1)) * gw \
                + jnp.clip(x, 0, gw - 1)
            key = jnp.where(ok, key, tn * gh * gw)
            at_min = ok & (depth <= flat_d[key])
            flat_i = flat_i.at[jnp.where(at_min, key, tn * gh * gw)].min(
                jnp.where(at_min, pid[:, None], jnp.iinfo(jnp.int32).max))
    imax = jnp.iinfo(jnp.int32).max
    didx = flat_i[:-1].reshape(tn, gh, gw)
    didx = jnp.where(didx == imax, -1, didx)
    return dmin, didx


def is_visible(cams: CameraSet, cloud: PatchCloud, grid: GridState,
               level: int, csize: int, coord, normal, image, ix, iy,
               strict):
    """Depth test against the front-most patch of cell (image, ix, iy)
    (reference patchOrganizerS.cpp:487-526).

    All args batched [...]; image must be a valid target index where the
    result matters. Returns bool [...].
    """
    tn, gh, gw = grid.shape
    inb = (ix >= 0) & (ix < gw) & (iy >= 0) & (iy < gh)
    img = jnp.clip(image, 0, tn - 1)
    cx = jnp.clip(ix, 0, gw - 1)
    cy = jnp.clip(iy, 0, gh - 1)
    didx = grid.depth_idx[img, cy, cx]
    empty = didx < 0
    dcoord = cloud.coord[jnp.maximum(didx, 0)]

    ray = coord - cams.center[img]
    ray = ray / jnp.linalg.norm(ray[..., :3], axis=-1, keepdims=True)
    diff = jnp.einsum("...k,...k->...", ray, coord - dcoord, precision=HIGHEST)
    factor = jnp.minimum(2.0, 2.0 + jnp.einsum(
        "...k,...k->...", ray[..., :3], normal[..., :3], precision=HIGHEST))
    unit = get_unit(cams, img, coord, level)
    ok = diff < unit * csize * strict * factor
    return inb & (empty | ok)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CellTable:
    """Sorted (cell-key -> patch) membership for bounded cell queries.

    entry e: patch `pid[e]` occupies cell `key[e]` (one entry per valid
    (patch, image-slot)). Sorted by key. `start`/`cnt` are DENSE
    [ncells+1] maps from cell key to the first entry of its run and the
    run length - one gather replaces a log2(E)-step binary search per
    query (searchsorted dominated the window-lookup cost at scale).
    Query helpers gather K consecutive entries from a cell's run - K
    caps the per-cell fan-out (the reference's std::vector per cell is
    unbounded).
    """

    key: jax.Array     # [E] i32 sorted cell keys (sentinel at invalid)
    pid: jax.Array     # [E] i32 patch index per entry
    start: jax.Array   # [ncells+1] i32 first entry of each cell's run
    cnt: jax.Array     # [ncells+1] i32 run length per cell
    sentinel: int = field(metadata=dict(static=True))

    def lookup(self, cell_key, k: int):
        """For each query cell key [...], return up to K patch ids
        occupying that cell: (pids [..., K], valid [..., K])."""
        ck = jnp.clip(cell_key, 0, self.sentinel - 1)
        offs = jnp.arange(k)
        idx = self.start[ck][..., None] + offs
        idx = jnp.clip(idx, 0, self.key.shape[0] - 1)
        hit = (offs < self.cnt[ck][..., None]) \
            & (cell_key[..., None] < self.sentinel) \
            & (cell_key[..., None] >= 0)
        return jnp.where(hit, self.pid[idx], -1), hit

    def lookup_flat(self, cell_key, k: int):
        """lookup with the K fan-out folded into the minor dim:
        cell_key [B, M] -> (pids, hit) both [B, M*K]; column m*K+j is
        the j-th occupant of query cell m. The folded 2-D layout keeps
        every gathered intermediate [B, M*K] with no small minor
        dimension."""
        ck = jnp.clip(cell_key, 0, self.sentinel - 1)
        startk = jnp.repeat(self.start[ck], k, axis=-1)      # [B, M*K]
        offsk = jnp.tile(jnp.arange(k), cell_key.shape[-1])
        idx = jnp.clip(startk + offsk[None], 0, self.key.shape[0] - 1)
        ok = (cell_key >= 0) & (cell_key < self.sentinel)
        hit = (offsk[None] < jnp.repeat(self.cnt[ck], k, axis=-1)) \
            & jnp.repeat(ok, k, axis=-1)
        return jnp.where(hit, self.pid[idx], -1), hit


def build_cell_table(cloud: PatchCloud, tn: int, gh: int, gw: int,
                     use_vgrids: bool = False,
                     merged: bool = False) -> CellTable:
    """Cell membership table over grids (pgrids), vgrids (vpgrids), or
    - with `merged` - their exact union (a patch's images and vimages
    are disjoint, so concatenating slots introduces no duplicates);
    querying the merged table once equals querying both tables, except
    the K fan-out cap applies to the union run."""
    if merged:
        images = jnp.concatenate([cloud.images, cloud.vimages], axis=1)
        grids = jnp.concatenate([cloud.grids, cloud.vgrids], axis=1)
    else:
        images = cloud.vimages if use_vgrids else cloud.images
        grids = cloud.vgrids if use_vgrids else cloud.grids
    key, valid = _flat_cells(images, grids, tn, gh, gw)
    sentinel = tn * gh * gw
    m = valid & cloud.alive[:, None]
    key = jnp.where(m, key, sentinel).reshape(-1)
    pid = jnp.broadcast_to(
        jnp.arange(cloud.capacity)[:, None], images.shape).reshape(-1)
    order = jnp.argsort(key)
    skey = key[order]
    e = skey.shape[0]
    start = jnp.full(sentinel + 1, e, jnp.int32).at[skey].min(
        jnp.arange(e, dtype=jnp.int32))
    cnt = jnp.zeros(sentinel + 1, jnp.int32).at[skey].add(1)
    # sentinel run must never be walked through queries
    start = start.at[sentinel].set(e)
    cnt = cnt.at[sentinel].set(0)
    return CellTable(key=skey, pid=pid[order], start=start, cnt=cnt,
                     sentinel=sentinel)


def window_pairs(tab: CellTable, cell_key, ok, pair_budget: int, k: int):
    """Compact (query-slot, cell-occupant) pairs to a static budget.

    cell_key/ok: [B, M] query cells per row (ok False skips a slot).
    Returns (rows [PB], eidx [PB], valid [PB], dropped []): pair i joins
    query row `rows[i]` with table entry `eidx[i]`. Hits are taken in
    (row, slot, run-position) order, capped at `k` per cell and
    `pair_budget` overall; `dropped` counts budget-overflow pairs (the
    caller should surface it - dropped pairs silently weaken
    neighbor-based decisions).

    The hit mask costs no gathers beyond the dense run-length lookup
    (offset < run length), so the expensive per-pair field gathers run
    on the ~1-5% of lanes that are real instead of the padded [B, M*K]
    fan-out - the structural fix for gather-bound window passes.
    Compaction runs in two stages: a nonzero scan compacts the
    non-empty query slots ([B*M] lanes), then each slot's run expands
    to pairs by an O(PB) cumsum/scatter-max/cummax walk (the previous
    [PB*K]-lane nonzero was the single hottest fusion of the whole
    filter stage on-chip). Every non-empty query yields >= 1 pair, so
    `pair_budget` bounds the stage-1 size too.
    """
    b, m = cell_key.shape
    e = tab.key.shape[0]
    ck = jnp.clip(cell_key, 0, tab.sentinel - 1)
    okq = ok & (cell_key >= 0) & (cell_key < tab.sentinel)
    # packed (cnt, start) so each stage pays ONE gather, not two
    cs = jnp.stack([tab.cnt, tab.start], axis=1)[ck]         # [B, M, 2]
    cnt = jnp.where(okq, jnp.minimum(cs[..., 0], k), 0)      # [B, M]
    start = cs[..., 1]

    # stage 1: compact the non-empty query slots
    qpos = jnp.nonzero((cnt > 0).reshape(-1), size=pair_budget,
                       fill_value=-1)[0]
    qval = qpos >= 0
    qp = jnp.maximum(qpos, 0)
    qrow = qp // m
    qcs = jnp.stack([cnt.reshape(-1), start.reshape(-1)], axis=1)[qp]
    qcnt = jnp.where(qval, qcs[:, 0], 0)
    qstart = qcs[:, 1]

    # stage 2: expand each slot's run into pairs. Slot i owns output
    # positions [offs[i], offs[i] + qcnt[i]); scatter each run's slot
    # index at its start position and forward-fill with cummax - every
    # pair then knows its slot in O(PB) work (valid slots are compacted
    # to the front, so offsets are monotone and runs are contiguous).
    offs = jnp.cumsum(qcnt) - qcnt                           # [PB]
    total = offs[-1] + qcnt[-1]
    tgt = jnp.where((qcnt > 0) & (offs < pair_budget), offs, pair_budget)
    mark = jnp.zeros(pair_budget + 1, jnp.int32).at[tgt].max(
        jnp.arange(qcnt.shape[0], dtype=jnp.int32))
    qi = jax.lax.cummax(mark[:pair_budget])
    pos = jnp.arange(pair_budget, dtype=jnp.int32)
    valid = pos < jnp.minimum(total, pair_budget)
    rso = jnp.stack([qrow, qstart, offs], axis=1)[qi]        # [PB, 3]
    rows = rso[:, 0]
    eidx = jnp.clip(rso[:, 1] + (pos - rso[:, 2]), 0, e - 1)
    dropped = jnp.maximum(cnt.sum() - valid.sum(), 0)
    return rows, eidx, valid, dropped


def count_window_pairs(tab: CellTable, cell_key, ok, k: int):
    """Exact pair count a window_pairs call would need (same gates) -
    lets callers size `pair_budget` before running the expensive pass."""
    ck = jnp.clip(cell_key, 0, tab.sentinel - 1)
    okq = ok & (cell_key >= 0) & (cell_key < tab.sentinel)
    return jnp.where(okq, jnp.minimum(tab.cnt[ck], k), 0).sum()


def soa_fields(cloud: PatchCloud):
    """Per-component views of coord/normal for padding-free gathers.

    Component arrays gathered as [P, M] keep each gather a plain
    2-D index lookup instead of a [huge, 4] row gather.
    """
    c = cloud.coord
    n = cloud.normal
    return ((c[:, 0], c[:, 1], c[:, 2]), (n[:, 0], n[:, 1], n[:, 2]),
            cloud.dscale)


def is_neighbor_comp(c0, n0, d0, cq, nq, dquery, hunit, threshold,
                     radius=None):
    """isNeighbor on pre-gathered component tuples (no gathers inside).

    c0/n0 and cq/nq: (x, y, z) tuples for the two sides; d0/dquery their
    dscales. Semantics identical to `is_neighbor` - callers that already
    hold packed per-pair fields use this to avoid per-component gathers.
    """
    qx, qy, qz = cq
    qnx, qny, qnz = nq
    dq_v = dquery
    ndot = n0[0] * qnx + n0[1] * qny + n0[2] * qnz
    ok = ndot >= jnp.cos(jnp.deg2rad(120.0))

    dx = qx - c0[0]
    dy = qy - c0[1]
    dz = qz - c0[2]
    vunit = d0 + dq_v
    f0 = n0[0] * dx + n0[1] * dy + n0[2] * dz
    f1 = qnx * dx + qny * dy + qnz * dz
    ftmp = (jnp.abs(f0) + jnp.abs(f1)) / 2.0
    ftmp = ftmp / jnp.where(vunit == 0.0, 1.0, vunit)
    hx = 2.0 * dx - n0[0] * f0 - qnx * f1
    hy = 2.0 * dy - n0[1] * f0 - qny * f1
    hz = 2.0 * dz - n0[2] * f0 - qnz * f1
    hsize = jnp.sqrt(hx * hx + hy * hy + hz * hz) / 2.0 / hunit
    if radius is not None:
        ok = ok & (hsize <= radius / hunit)
    ftmp = jnp.where(hsize > 1.0, ftmp / jnp.minimum(2.0, hsize), ftmp)
    return ok & (ftmp < threshold)


def is_neighbor_soa(c0, n0, d0, q, cx, cy, cz, nx, ny, nz, dq,
                    hunit, threshold, radius=None):
    """Component-wise isNeighbor against gathered candidates.

    c0/n0: tuples of (x, y, z) arrays for the query patch, broadcastable
    to the candidate index array `q`; cx..dq: the cloud's component
    arrays (gathered at q inside). Semantics identical to `is_neighbor`.
    """
    qx, qy, qz = cx[q], cy[q], cz[q]
    qnx, qny, qnz = nx[q], ny[q], nz[q]
    ndot = n0[0] * qnx + n0[1] * qny + n0[2] * qnz
    ok = ndot >= jnp.cos(jnp.deg2rad(120.0))

    dx = qx - c0[0]
    dy = qy - c0[1]
    dz = qz - c0[2]
    vunit = d0 + dq[q]
    f0 = n0[0] * dx + n0[1] * dy + n0[2] * dz
    f1 = qnx * dx + qny * dy + qnz * dz
    ftmp = (jnp.abs(f0) + jnp.abs(f1)) / 2.0
    ftmp = ftmp / jnp.where(vunit == 0.0, 1.0, vunit)
    hx = 2.0 * dx - n0[0] * f0 - qnx * f1
    hy = 2.0 * dy - n0[1] * f0 - qny * f1
    hz = 2.0 * dz - n0[2] * f0 - qnz * f1
    hsize = jnp.sqrt(hx * hx + hy * hy + hz * hz) / 2.0 / hunit
    if radius is not None:
        ok = ok & (hsize <= radius / hunit)
    ftmp = jnp.where(hsize > 1.0, ftmp / jnp.minimum(2.0, hsize), ftmp)
    return ok & (ftmp < threshold)


def is_neighbor(coord0, normal0, dscale0, coord1, normal1, dscale1,
                hunit, threshold, radius=None):
    """Coplanarity neighbor predicate (reference findMatch.cpp:125-185).

    All inputs broadcastable; hunit is the cross-patch pixel scale. When
    `radius` is given the isNeighborRadius variant is used.
    """
    ndot = jnp.einsum("...k,...k->...", normal0[..., :3], normal1[..., :3],
                      precision=HIGHEST)
    ok = ndot >= jnp.cos(jnp.deg2rad(120.0))

    diff = coord1 - coord0
    vunit = dscale0 + dscale1
    f0 = jnp.einsum("...k,...k->...", normal0, diff, precision=HIGHEST)
    f1 = jnp.einsum("...k,...k->...", normal1, diff, precision=HIGHEST)
    ftmp = (jnp.abs(f0) + jnp.abs(f1)) / 2.0
    ftmp = ftmp / jnp.where(vunit == 0.0, 1.0, vunit)
    hvec = (2.0 * diff - normal0 * f0[..., None] - normal1 * f1[..., None])
    hsize = jnp.linalg.norm(hvec[..., :3], axis=-1) / 2.0 / hunit
    if radius is not None:
        ok = ok & (hsize <= radius / hunit)
    ftmp = jnp.where(hsize > 1.0, ftmp / jnp.minimum(2.0, hsize), ftmp)
    return ok & (ftmp < threshold)
