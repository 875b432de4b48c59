"""Cluster-level scheduling: the in-process replacement for pmvs.sh.

The reference's distributed backend is genOption's shell script - one
pmvs2 process per cluster, sharing nothing at runtime (reference
source/genOption.cpp:58-74; SURVEY.md section 2.5 row 3). Here the same
artifacts (ske.dat -> option-%04d + pmvs.sh) drive a scheduler:

  * clusters are assigned to JAX processes (hosts) by static round-robin
    over `jax.process_index()` - one process per host or per card; each
    host reconstructs its clusters on its local devices,
  * within one cluster the (patch x view) mesh of parallel/sharding
    shards refinement waves over local devices,
  * per-cluster patch clouds merge by concatenation - exactly the
    downstream contract of the reference pipeline (clusters share
    nothing at runtime; CMVS's `oimages` overlap is the halo, re-read
    from disk by every cluster that needs it).

Checkpoint/resume: with `checkpoint=True` each cluster records a
completion marker, so a preempted multi-host run re-runs only the
clusters that had not finished (the elastic-recovery story the
reference lacks, SURVEY.md section 5.3-5.4).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field


@dataclass
class ClusterRun:
    """Outcome of one cluster reconstruction."""

    name: str
    patches: int = 0
    seconds: float = 0.0
    skipped: bool = False
    stats: list = field(default_factory=list)


def discover_options(prefix: str) -> list[str]:
    """Cluster option files in pmvs.sh order (genOption.cpp:58-74), or
    by option-%04d glob when no script exists."""
    script = os.path.join(prefix, "pmvs.sh")
    names: list[str] = []
    if os.path.exists(script):
        with open(script) as f:
            for line in f:
                m = re.search(r"(option-\d{4})\s*$", line.strip())
                if m:
                    names.append(m.group(1))
        if names:
            return names
    for fname in sorted(os.listdir(prefix)):
        if re.fullmatch(r"option-\d{4}", fname):
            names.append(fname)
    return names


def assign_clusters(names: list[str], process_index: int,
                    process_count: int) -> list[str]:
    """Static round-robin cluster -> host map. Deterministic, so every
    process derives the same global assignment with no coordination
    (the filesystem stays the only shared medium, as in the
    reference)."""
    return [n for i, n in enumerate(names)
            if i % process_count == process_index]


def run_clusters(prefix: str, names: list[str] | None = None,
                 process_index: int | None = None,
                 process_count: int | None = None,
                 p_cap: int = 200_000, log=print, checkpoint: bool = False,
                 **run_kwargs) -> list[ClusterRun]:
    """Reconstruct this process's share of the clusters.

    Replaces `sh pmvs.sh` (one OS process per line) with one scheduler
    per host. Returns a ClusterRun per assigned cluster.
    """
    import time

    if process_index is None or process_count is None:
        import jax
        process_index = jax.process_index()
        process_count = jax.process_count()
    if names is None:
        names = discover_options(prefix)
    mine = assign_clusters(names, process_index, process_count)
    from ..models.engine import reconstruct

    results: list[ClusterRun] = []
    for name in mine:
        done_marker = os.path.join(prefix, "models", name + ".done")
        if checkpoint and os.path.exists(done_marker):
            log(f"[{name}] already complete, skipping")
            results.append(ClusterRun(name=name, skipped=True))
            continue
        t0 = time.time()
        log(f"[{name}] reconstructing on process "
            f"{process_index}/{process_count}")
        eng = reconstruct(prefix, name, p_cap=p_cap, log=log, **run_kwargs)
        run = ClusterRun(name=name, patches=int(eng.cloud.count()),
                         seconds=time.time() - t0, stats=eng.stats)
        if checkpoint:
            with open(done_marker, "w") as f:
                f.write(f"{run.patches} {run.seconds:.3f}\n")
        results.append(run)
    return results


def merge_models(prefix: str, names: list[str] | None = None,
                 out_name: str = "all") -> str:
    """Concatenate per-cluster outputs into models/<out_name>.{patch,
    pset,ply}. The reference leaves this to downstream tools (each
    pmvs2 process writes its own models/option-%04d.*); provided here
    so a multi-host run ends in one cloud. Returns the output stem."""
    import numpy as np

    from ..io.patches import read_patch_file, write_patch_file, write_pset
    from ..io.ply import write_patch_ply

    if names is None:
        names = discover_options(prefix)
    records = []
    plys = []
    for name in names:
        stem = os.path.join(prefix, "models", name)
        if os.path.exists(stem + ".patch"):
            records.extend(read_patch_file(stem + ".patch"))
        if os.path.exists(stem + ".ply"):
            plys.append(stem + ".ply")
    out = os.path.join(prefix, "models", out_name)
    write_patch_file(out + ".patch", records)
    coords = np.array([r.coord[:3] for r in records]).reshape(-1, 3)
    normals = np.array([r.normal[:3] for r in records]).reshape(-1, 3)
    ncc = np.array([r.ncc for r in records])
    write_pset(out + ".pset", coords, normals)
    _merge_plys(plys, out + ".ply", coords, normals, ncc)
    return out


def _merge_plys(plys: list[str], out_path: str, coords, normals, ncc):
    """Merge per-cluster PLYs preserving per-patch colors when present;
    falls back to gray if the vertex lines cannot be reused."""
    lines = []
    for path in plys:
        with open(path) as f:
            in_body = False
            for line in f:
                if in_body:
                    lines.append(line)
                elif line.strip() == "end_header":
                    in_body = True
    if len(lines) == len(coords):
        from ..io.ply import _HEADER
        with open(out_path, "w") as f:
            f.write(_HEADER.format(n=len(lines)))
            f.writelines(lines)
    else:
        from ..io.ply import write_patch_ply
        write_patch_ply(out_path, coords, normals, quality=ncc)
