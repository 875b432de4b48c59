"""PatchCloud: the reconstruction state as fixed-capacity struct-of-arrays.

Batched replacement for the reference's heap-allocated patch objects and
shared_ptr grids (reference include/pmvs/patch.hpp, patchOrganizerS.hpp):
one dense tensor per field, an `alive` mask instead of allocation, and
compaction by sort instead of erase. Capacities are static so every phase
jits once.

Field semantics follow CPatch (patch.hpp:29-76):
  coord [P,4] center (w=1) | normal [P,4] (w=0) | ncc [P]
  images [P,T] engine indexes, slot 0 = reference view, -1 = empty
  grids [P,T,2] cell (ix, iy) per image slot
  vimages/vgrids: depth-test-only visible target images
  timages [P]: number of target images among `images`
  dscale/ascale [P]: refinement step scales
  dflag [P]: 6-bit expansion-failure bitmask
  alive [P]: live patch mask
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PatchCloud:
    coord: jax.Array     # [P, 4]
    normal: jax.Array    # [P, 4]
    ncc: jax.Array       # [P]
    images: jax.Array    # [P, T] int32, -1 padded
    grids: jax.Array     # [P, T, 2] int32
    vimages: jax.Array   # [P, T] int32
    vgrids: jax.Array    # [P, T, 2] int32
    timages: jax.Array   # [P] int32
    dscale: jax.Array    # [P]
    ascale: jax.Array    # [P]
    dflag: jax.Array     # [P] int32
    alive: jax.Array     # [P] bool

    @property
    def capacity(self) -> int:
        return self.coord.shape[0]

    @property
    def max_views(self) -> int:
        return self.images.shape[1]

    def count(self) -> jax.Array:
        return self.alive.sum()

    def score2(self, ncc_threshold) -> jax.Array:
        """max(0, ncc - thr) * timages (patch.hpp:49-51)."""
        return (jnp.maximum(0.0, self.ncc - ncc_threshold)
                * self.timages.astype(self.ncc.dtype))


def empty_cloud(capacity: int, max_views: int,
                dtype=jnp.float32) -> PatchCloud:
    p, t = capacity, max_views
    return PatchCloud(
        coord=jnp.zeros((p, 4), dtype),
        normal=jnp.zeros((p, 4), dtype),
        ncc=jnp.full((p,), -1.0, dtype),
        images=jnp.full((p, t), -1, jnp.int32),
        grids=jnp.zeros((p, t, 2), jnp.int32),
        vimages=jnp.full((p, t), -1, jnp.int32),
        vgrids=jnp.zeros((p, t, 2), jnp.int32),
        timages=jnp.zeros((p,), jnp.int32),
        dscale=jnp.zeros((p,), dtype),
        ascale=jnp.zeros((p,), dtype),
        dflag=jnp.zeros((p,), jnp.int32),
        alive=jnp.zeros((p,), bool),
    )


def append_patches(cloud: PatchCloud, new: PatchCloud,
                   new_mask) -> tuple[PatchCloud, jax.Array]:
    """Append `new`'s masked rows into free slots of `cloud`.

    Deterministic: free slots are filled in index order. Returns
    (cloud, dropped) where `dropped` counts incoming rows that did not
    fit - callers surface it so capacity overflow is visible, not a
    silent truncation (growing capacity costs one re-jit at the new
    static size).
    """
    p = cloud.capacity
    free = ~cloud.alive                       # [P]
    # destination slot for the k-th incoming patch = index of k-th free slot
    free_idx = jnp.nonzero(free, size=p, fill_value=p)[0]
    k = jnp.cumsum(new_mask.astype(jnp.int32)) - 1       # rank per new row
    dest = jnp.where(new_mask, free_idx[jnp.clip(k, 0, p - 1)], p)
    dropped = (new_mask & (dest >= p)).sum()
    # rows with dest == p fall into a discard slot via clipped scatter-drop
    def scat(dst_arr, src_arr):
        return dst_arr.at[dest].set(src_arr, mode="drop")

    return PatchCloud(
        coord=scat(cloud.coord, new.coord),
        normal=scat(cloud.normal, new.normal),
        ncc=scat(cloud.ncc, new.ncc),
        images=scat(cloud.images, new.images),
        grids=scat(cloud.grids, new.grids),
        vimages=scat(cloud.vimages, new.vimages),
        vgrids=scat(cloud.vgrids, new.vgrids),
        timages=scat(cloud.timages, new.timages),
        dscale=scat(cloud.dscale, new.dscale),
        ascale=scat(cloud.ascale, new.ascale),
        dflag=scat(cloud.dflag, new.dflag),
        alive=cloud.alive.at[dest].set(new_mask, mode="drop"),
    ), dropped


@jax.jit
def compact_cloud(cloud: PatchCloud) -> tuple[PatchCloud, jax.Array]:
    """Stable-sort alive rows to the array prefix.

    Keeping the live cloud as a prefix lets the engine run every phase on
    a sliced power-of-two bucket instead of full capacity (the reference
    pays per-patch cost only for live patches; our dense phases otherwise
    pay capacity). Returns (cloud, inv) where inv[old_row] = new_row, for
    remapping derived per-cell patch indices (GridState.depth_idx).
    """
    import dataclasses
    p = cloud.capacity
    order = jnp.argsort(~cloud.alive, stable=True)
    inv = jnp.zeros(p, jnp.int32).at[order].set(
        jnp.arange(p, dtype=jnp.int32))
    c2 = PatchCloud(**{f.name: getattr(cloud, f.name)[order]
                       for f in dataclasses.fields(cloud)})
    return c2, inv


def remove_patches(cloud: PatchCloud, kill_mask) -> PatchCloud:
    """Mark patches dead (reference removePatch erases from grids; our
    grids are rebuilt per pass from the alive set)."""
    return replace(cloud, alive=cloud.alive & ~kill_mask)
