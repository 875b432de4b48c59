"""Whole-engine multi-chip execution: GSPMD sharding of every phase.

The reference parallelizes reconstruction as one OS process per cluster
with the filesystem as the backend (reference source/genOption.cpp:58-74;
SURVEY.md 2.5). In-engine, the replacement shards the patch cloud -
the state every phase reads and writes - across a device mesh's `patch`
axis and lets XLA GSPMD partition each jitted phase program, inserting
the collectives the design calls for (SURVEY.md 5.8): all-gathers where
a phase needs another shard's patches (cell-table neighbor lookups),
scatter-reductions for the depth maps, and reduction collectives for the
filter gains. The handwritten (patch x view) shard_map path
(parallel/sharding.py) remains the explicitly-scheduled tensor-parallel
variant of the refine kernel; this module is the data-parallel engine
story on top.

Usage: PMVSEngine(..., mesh=make_engine_mesh(n)) - the engine re-pins
its state to the mesh after every phase so sharding survives phase
boundaries regardless of what layout GSPMD chose for a program's
outputs.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_engine_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """One-axis (`patch`) mesh for data-parallel engine execution."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return Mesh(np.array(devices[:n_devices]), ("patch",))


def _shard_leading(mesh: Mesh, a):
    if not hasattr(a, "ndim") or a.ndim == 0:
        return a
    n = mesh.devices.size
    if a.shape[0] % n != 0:
        return jax.device_put(a, NamedSharding(mesh, P()))
    spec = P("patch", *([None] * (a.ndim - 1)))
    return jax.device_put(a, NamedSharding(mesh, spec))


def pin_cloud(mesh: Mesh, cloud):
    """Shard every [P_cap, ...] array of a PatchCloud over `patch`."""
    return jax.tree_util.tree_map(lambda a: _shard_leading(mesh, a),
                                  cloud)


def pin_replicated(mesh: Mesh, tree):
    """Replicate a pytree (grids, pyramids, cameras) on every device."""
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P()))
        if hasattr(a, "ndim") else a, tree)


def round_capacity(p_cap: int, mesh: Mesh | None) -> int:
    """Round the cloud capacity up so the patch axis divides evenly."""
    if mesh is None:
        return p_cap
    n = mesh.devices.size
    return -(-p_cap // n) * n
