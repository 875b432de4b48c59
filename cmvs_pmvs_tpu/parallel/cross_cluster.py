"""In-engine cross-cluster halo exchange over collectives (prototype).

The reference's cluster parallelism shares nothing at runtime: one
pmvs2 process per option-%04d file, coordinated only by genOption's
shell script (reference source/genOption.cpp:58-74), with CMVS's
`oimages` overlap as the implicit halo each cluster re-reads from
disk. SURVEY.md section 5.8's in-engine seam replaces that file-only
handoff with an in-engine exchange at cluster boundaries - this module
is the prototype (VERDICT r4 item 8: 2 clusters, correctness first):

  * after each expand/filter iteration, the clusters' per-image
    depth-map minima and cell-occupancy counts for SHARED images are
    combined with `lax.pmin` / `lax.pmax` over a 'cluster' mesh axis
    inside shard_map - so the next expansion sees the other cluster's
    surfaces as occlusion and occupancy, exactly what a single-engine
    run of the union would see;
  * up to K boundary frontier patches (alive patches observing a
    shared image) are `lax.ppermute`d to the other cluster and
    injected into its cloud, where the normal visibility rebuild
    integrates them; duplicates die in the filters like any other
    co-cell patch.

The combined depth/occupancy is transient (the engine's own
refresh_visibility rebuilds from the local cloud), but the injected
frontier patches persist - matching the reference's semantics where
overlap images carry the cross-cluster constraint.
"""
from __future__ import annotations

from dataclasses import replace
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def make_cluster_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()[:2]
    return Mesh(np.array(devices[:2]), ("c",))


@partial(jax.jit, static_argnames=("mesh",))
def _exchange_program(mesh, depth_g, occ_g, share_g, bp_g):
    """Collective halo combine on the 'c' axis.

    depth_g [2, NG, GH, GW] f32 (+inf where the cluster has no data),
    occ_g [2, NG, GH, GW] i32, share_g [2, NG] bool (images this
    cluster shares with the other), bp_g [2, K, 11] boundary patch
    rows (coord4 | normal4 | ncc | dscale | valid).
    Returns (depth', occ', other_bp [2, K, 11]).
    """
    def body(depth, occ, share, bp):
        dmin = jax.lax.pmin(depth, "c")
        omax = jax.lax.pmax(occ, "c")
        gate = share[0, :, None, None]
        depth2 = jnp.where(gate, dmin[0], depth[0])[None]
        occ2 = jnp.where(gate, jnp.maximum(occ[0], omax[0]),
                         occ[0])[None]
        other = jax.lax.ppermute(bp, "c", [(0, 1), (1, 0)])
        return depth2, occ2, other

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("c"), P("c"), P("c"), P("c")),
        out_specs=(P("c"), P("c"), P("c")))(depth_g, occ_g, share_g,
                                            bp_g)


def _boundary_patches(eng, shared_local: np.ndarray, k: int):
    """Up to `k` alive patches that observe a shared image, as
    [k, 11] rows (coord4 | normal4 | ncc | dscale | valid)."""
    cloud = eng.cloud
    alive = np.asarray(cloud.alive)
    images = np.asarray(cloud.images)
    shared_set = set(int(i) for i in shared_local)
    obs = np.isin(images, list(shared_set) or [-2]).any(axis=1)
    rows = np.nonzero(alive & obs)[0]
    if len(rows) > k:
        # strongest first: the frontier worth telling the other side
        ncc = np.asarray(cloud.ncc)[rows]
        rows = rows[np.argsort(-ncc)[:k]]
    out = np.zeros((k, 11), np.float32)
    n = len(rows)
    if n:
        out[:n, 0:4] = np.asarray(cloud.coord)[rows]
        out[:n, 4:8] = np.asarray(cloud.normal)[rows]
        out[:n, 8] = np.asarray(cloud.ncc)[rows]
        out[:n, 9] = np.asarray(cloud.dscale)[rows]
        out[:n, 10] = 1.0
    return out


def _inject_patches(eng, bp: np.ndarray, id_map: dict):
    """Append foreign frontier patches to `eng`'s cloud: image slots
    mapped global->local; grids from fresh projections; vimages left
    for the next refresh_visibility to discover."""
    from ..geom.cameras import project
    valid = bp[:, 10] > 0.5
    bp = bp[valid]
    if not len(bp):
        return 0
    coord = bp[:, 0:4]
    cams = eng.scene.cams
    cfg = eng.cfg
    # local views that actually see each patch (projection in bounds,
    # facing) - reference preProcess semantics at its cheapest
    P_all = np.asarray(cams.P)
    t = eng.cloud.max_views
    n_new = len(bp)
    images = np.full((n_new, t), -1, np.int32)
    grids = np.zeros((n_new, t, 2), np.int32)
    keep = np.zeros(n_new, bool)
    widths = np.asarray(eng.scene.pyr.widths[cfg.level])
    heights = np.asarray(eng.scene.pyr.heights[cfg.level])
    scale = 2.0 ** cfg.level
    for r in range(n_new):
        slots = 0
        for li in range(cfg.tn):
            q = P_all[li] @ coord[r]
            if q[2] <= 0:
                continue
            x, y = q[0] / q[2] / scale, q[1] / q[2] / scale
            if not (0 <= x < widths[li] and 0 <= y < heights[li]):
                continue
            ray = np.asarray(cams.center)[li, :3] - coord[r, :3]
            ray = ray / np.linalg.norm(ray)
            if ray @ bp[r, 4:7] < 0.5:
                continue
            if slots < t:
                images[r, slots] = li
                grids[r, slots] = (int(x + 0.5) // cfg.csize,
                                   int(y + 0.5) // cfg.csize)
                slots += 1
        keep[r] = slots >= cfg.min_image_num
    images = images[keep]
    grids = grids[keep]
    bp = bp[keep]
    n_new = len(bp)
    if not n_new:
        return 0

    n_alive = int(np.asarray(eng.cloud.count()))
    if n_alive + n_new > eng.p_cap:
        eng._grow(n_alive + n_new)
    eng._compact()
    cloud = eng.cloud
    sl = slice(n_alive, n_alive + n_new)
    f32 = cloud.coord.dtype
    eng.cloud = replace(
        cloud,
        coord=cloud.coord.at[sl].set(jnp.asarray(bp[:, 0:4], f32)),
        normal=cloud.normal.at[sl].set(jnp.asarray(bp[:, 4:8], f32)),
        ncc=cloud.ncc.at[sl].set(jnp.asarray(bp[:, 8], f32)),
        dscale=cloud.dscale.at[sl].set(jnp.asarray(bp[:, 9], f32)),
        ascale=cloud.ascale.at[sl].set(
            jnp.asarray(np.full(n_new, 0.5), f32)),
        images=cloud.images.at[sl].set(jnp.asarray(images)),
        grids=cloud.grids.at[sl].set(jnp.asarray(grids)),
        vimages=cloud.vimages.at[sl].set(-1),
        timages=cloud.timages.at[sl].set(
            jnp.asarray((images >= 0).sum(1), jnp.int32)),
        dflag=cloud.dflag.at[sl].set(0),
        alive=cloud.alive.at[sl].set(True))
    eng._pin()
    return n_new


def exchange_halo(engines, mesh: Mesh, k_frontier: int = 256):
    """One cross-cluster exchange between two live engines.

    Combines shared-image depth minima + occupancy through the 'c'
    mesh axis collectives and injects each side's boundary frontier
    into the other. Returns the number of patches injected per engine.
    """
    assert len(engines) == 2
    # global image-id universe
    ids = [list(e.scene.image_ids) for e in engines]
    gids = sorted(set(ids[0]) | set(ids[1]))
    g_of = {g: i for i, g in enumerate(gids)}
    ng = len(gids)
    shared = set(ids[0]) & set(ids[1])

    gh, gw = engines[0].cfg.gh, engines[0].cfg.gw
    assert (gh, gw) == (engines[1].cfg.gh, engines[1].cfg.gw), \
        "prototype requires equal grid shapes"
    depth_g = np.full((2, ng, gh, gw), np.inf, np.float32)
    occ_g = np.zeros((2, ng, gh, gw), np.int32)
    share_g = np.zeros((2, ng), bool)
    bp_g = np.zeros((2, k_frontier, 11), np.float32)
    for c, eng in enumerate(engines):
        tn = eng.cfg.tn
        loc2g = [g_of[g] for g in ids[c][:tn]]
        depth_g[c, loc2g] = np.asarray(eng.grid.depth)[:tn]
        occ_g[c, loc2g] = np.asarray(eng.grid.occ)[:tn]
        share_g[c, [g_of[g] for g in shared]] = True
        shared_local = np.array(
            [li for li, g in enumerate(ids[c][:tn]) if g in shared])
        bp_g[c] = _boundary_patches(eng, shared_local, k_frontier)

    depth2, occ2, other = _exchange_program(
        mesh, jnp.asarray(depth_g), jnp.asarray(occ_g),
        jnp.asarray(share_g), jnp.asarray(bp_g))
    depth2 = np.asarray(depth2)
    occ2 = np.asarray(occ2)
    other = np.asarray(other)

    injected = []
    for c, eng in enumerate(engines):
        tn = eng.cfg.tn
        loc2g = [g_of[g] for g in ids[c][:tn]]
        eng.grid = replace(
            eng.grid,
            depth=eng.grid.depth.at[:tn].set(
                jnp.asarray(depth2[c, loc2g])),
            occ=eng.grid.occ.at[:tn].set(jnp.asarray(occ2[c, loc2g])))
        inj = _inject_patches(eng, other[c],
                              {g: li for li, g in enumerate(ids[c])})
        injected.append(inj)
    return injected
