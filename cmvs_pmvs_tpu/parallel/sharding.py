"""Multi-chip sharding of the reconstruction step.

The reference's "distributed backend" is the filesystem + one process per
cluster (SURVEY.md section 2.5). The in-process replacement is a
jax.sharding.Mesh with two axes:

  * `patch` - the data-parallel axis: the candidate/refine batch and the
    patch cloud are sharded across it; per-image depth maps are produced
    per shard and merged by a min-collective (the reference's per-cell
    scatter-min under image locks).
  * `view`  - the tensor-parallel axis: each shard grabs textures for its
    slice of a patch's views and the Gauss-Newton normal equations /
    INCC sums are psum'd across devices (ops/refine accepts `view_axis`).

Cluster-level (multi-host) partitioning composes on top: CMVS clusters map
to independent mesh slices with `oimages` overlap exchanged between them
(see models/cmvs).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..geom.cameras import HIGHEST, CameraSet, project
from ..image.pyramid import PyramidSet
from ..ops.refine import (
    RefineProblem, compute_weighted_incc, make_problem, refine_patches,
)


def make_mesh(n_devices: int | None = None, view_parallel: int = 1,
              devices=None) -> Mesh:
    """Mesh over (patch, view) axes from the first n_devices devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.array(devices[:n_devices])
    assert n_devices % view_parallel == 0
    grid = devices.reshape(n_devices // view_parallel, view_parallel)
    return Mesh(grid, ("patch", "view"))


def shard_views(views, valid, n_shards: int):
    """Split a [B, T] view table into per-shard slices that each keep the
    reference (slot 0) and take every n_shards-th other view:
    returns [B, n_shards, 1 + ceil((T-1)/n_shards)] stacked tables to be
    sharded over the `view` axis."""
    b, t = views.shape
    per = -(-(t - 1) // n_shards)
    pads = n_shards * per - (t - 1)
    ov = jnp.pad(views[:, 1:], ((0, 0), (0, pads)), constant_values=-1)
    oval = jnp.pad(valid[:, 1:], ((0, 0), (0, pads)))
    ov = ov.reshape(b, per, n_shards).transpose(0, 2, 1)
    oval = oval.reshape(b, per, n_shards).transpose(0, 2, 1)
    ref = jnp.broadcast_to(views[:, None, :1], (b, n_shards, 1))
    refv = jnp.broadcast_to(valid[:, None, :1], (b, n_shards, 1))
    return (jnp.concatenate([ref, ov], axis=2),
            jnp.concatenate([refv, oval], axis=2))


def sharded_refine_step(mesh: Mesh, cams: CameraSet, pyr: PyramidSet,
                        level: int, wsize: int, min_image_num: int,
                        csize: int, tn: int, gh: int, gw: int,
                        num_iters: int = 8):
    """Build the jitted multi-chip wave step.

    Input batch (coord [B,4], normal [B,4], views [B,T], valid [B,T],
    dscale [B], active [B]) is sharded over `patch`; each patch's views
    are additionally split over `view`. Returns refined
    (coord, normal, ncc) plus globally min-merged depth maps
    [TN, GH, GW] - the cross-shard visibility exchange.
    """
    np_, nv = mesh.devices.shape

    def step(coord, normal, views_s, valid_s, dscale, active):
        # views_s: [b_local, nv_local=1, T_local] after sharding
        views_l = views_s[:, 0]
        valid_l = valid_s[:, 0]
        prob = make_problem(cams, level, coord, normal, views_l, valid_l,
                            dscale, min_image_num)
        coord2, normal2, ncc, _ = refine_patches(
            cams, pyr, level, wsize, prob, coord, normal,
            num_iters=num_iters, active=active, view_axis="view")

        # local depth-map contribution + min-merge over the patch axis
        tgt = jnp.arange(tn)
        ic = project(cams.P[tgt][None], coord2[:, None, :], level)
        cx = jnp.floor(ic[..., 0] / csize).astype(jnp.int32)
        cy = jnp.floor(ic[..., 1] / csize).astype(jnp.int32)
        depth = jnp.einsum("tk,pk->pt", cams.oaxis[tgt], coord2,
                           precision=HIGHEST)
        ok = (active[:, None] & (ic[..., 2] > 0) & (cx >= 0) & (cx < gw)
              & (cy >= 0) & (cy < gh))
        key = (tgt[None] * gh + jnp.clip(cy, 0, gh - 1)) * gw \
            + jnp.clip(cx, 0, gw - 1)
        flat = jnp.full(tn * gh * gw + 1, jnp.inf)
        flat = flat.at[jnp.where(ok, key, tn * gh * gw)].min(
            jnp.where(ok, depth, jnp.inf))
        dmap = flat[:-1].reshape(tn, gh, gw)
        dmap = jax.lax.pmin(dmap, "patch")
        dmap = jax.lax.pmin(dmap, "view")
        return coord2, normal2, ncc, dmap

    spec_p = P("patch")
    fn = shard_map(
        step, mesh=mesh,
        in_specs=(spec_p, spec_p, P("patch", "view"), P("patch", "view"),
                  spec_p, spec_p),
        out_specs=(spec_p, spec_p, spec_p, P()),
        check_vma=False)
    return jax.jit(fn)
