#!/usr/bin/env python3
"""Proof that the pmvs3 main path runs on NVIDIA GPUs.

    python chip_smoke.py               # phases a-d on one card
    python chip_smoke.py --four-cards  # the four-card phases only

Phases (each passes or the script exits non-zero):
  a. device: the default JAX backend must be a GPU;
  b. evaluator: the refine objective (ops/refine.per_view_inccs) at
     8,192 patches x 6 views, 640x480, wsize 7, against the float64
     host reference (ops/incc_reference.py);
  c. main path: `pmvs3` on the full reference protocol (12 views at
     640x480, masks, setEdge 0.4, level 0, run(3) to fixpoint): cold;
     warm, after dropping every in-memory compiled program, so it loads
     its executables from the persistent cache as a second pmvs3
     process would; and steady, with every program in memory;
  d. one scene on two backends: the small e2e scene (8 views, 192x144)
     on the GPU and on the host CPU backend of the same process.
Four cards:
  i.  cluster placement: cmvs3 -> genOption -> pmvs3_all on a 48-view
      ring, one pmvs3_all process per card, against the same clusters
      run one after another on one card;
  ii. the sharded engine (PMVSEngine over a 4-device `patch` mesh) on
      the full-protocol scene against the one-card engine.

The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# phase d needs the host CPU backend beside the GPU one
if os.environ.get("JAX_PLATFORMS") and \
        "cpu" not in os.environ["JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

FULL = dict(num_cameras=12, width=640, height=480, focal=700.0,
            mask_border=8,
            option="level 0\ncsize 2\nthreshold 0.7\nwsize 7\n"
                   "minImageNum 3\nCPU 4\nsetEdge 0.4\nuseBound 0\n"
                   "useVisData 0\nsequence -1\ntimages -1 0 12\n"
                   "oimages 0\n")
SMALL = dict(num_cameras=8, width=192, height=144, focal=300.0,
             mask_border=0,
             option="level 0\ncsize 2\nthreshold 0.7\nwsize 7\n"
                    "minImageNum 3\nCPU 4\nsetEdge 0\nuseBound 0\n"
                    "useVisData 0\nsequence -1\ntimages -1 0 8\n"
                    "oimages 0\n")
SMALL_RUN = dict(expand_iters=1, max_waves=2, refine_iters=8)
INCC_TOL = 1e-4          # max |dINCC| vs the float64 reference
SURFACE_P50_MAX = 0.3    # median surface error, in dscale units


def check(cond: bool, what: str):
    if not cond:
        print(f"FAIL: {what}", flush=True)
        sys.exit(1)


def say(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


class CacheEvents:
    """Counts persistent-compilation-cache hits and misses."""

    def __init__(self):
        import jax
        self.counts: dict[str, int] = {}
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, name, **_):
        if name.startswith("/jax/compilation_cache/"):
            key = name.rsplit("/", 1)[-1]
            self.counts[key] = self.counts.get(key, 0) + 1

    def snapshot(self) -> dict:
        return dict(self.counts)


@contextlib.contextmanager
def no_cache_writes():
    """Compile without writing the persistent cache (the CPU backend
    has crashed serializing the largest engine executable)."""
    import jax
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    try:
        yield
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old)


# ------------------------------------------------------------- phase a
def phase_device(expect_count: int | None = None):
    import jax
    import jaxlib
    from importlib import metadata
    check(jax.default_backend() == "gpu",
          f"default JAX backend is {jax.default_backend()!r}, not 'gpu'")
    devs = jax.devices()
    if expect_count is not None:
        check(len(devs) == expect_count,
              f"{len(devs)} devices, expected {expect_count}")
    plugins = sorted(f"{d.metadata['Name']} {d.version}"
                     for d in metadata.distributions()
                     if "cuda" in (d.metadata["Name"] or "").lower()
                     and "jax" in (d.metadata["Name"] or "").lower())
    say(f"[a] gpu: {gpu_line()}")
    say(f"[a] jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"plugins: {', '.join(plugins) or 'none found'}")
    say(f"[a] devices: {len(devs)} x {devs[0].device_kind}")
    return devs


# ------------------------------------------------------------- phase b
def bench_problem(batch: int = 8192, num_cameras: int = 6,
                  width: int = 640, height: int = 480, focal: float = 800.0,
                  wsize: int = 7, seed: int = 0):
    """Refine-evaluator inputs at the kernel bench shape: `batch`
    patches on the textured plane seen by every camera, depth-perturbed
    by up to 2 dscale along the reference ray."""
    import jax.numpy as jnp
    from cmvs_pmvs_tpu.geom import build_camera_set
    from cmvs_pmvs_tpu.image import build_pyramids
    from cmvs_pmvs_tpu.ops.refine import make_problem, set_scales
    from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene

    scene = make_plane_scene(num_cameras=num_cameras, width=width,
                             height=height, focal=focal)
    cams = build_camera_set(scene.P, dtype=jnp.float32)
    pyr = build_pyramids(list(scene.images), None, num_levels=3)
    rng = np.random.default_rng(seed)
    C, P = scene.centers[0], scene.P[0]
    us = rng.uniform(0.19 * width, 0.81 * width, batch)
    vs = rng.uniform(0.19 * height, 0.81 * height, batch)
    X1 = np.linalg.solve(P[:, :3], np.stack([us, vs, np.ones(batch)])
                         - P[:, 3:4]).T
    d = X1 - C
    s = -(C @ scene.plane_n) / (d @ scene.plane_n)
    pts = C + s[:, None] * d
    coord = np.concatenate([pts, np.ones((batch, 1))], 1)
    normal = np.tile(np.append(scene.plane_n, 0.0), (batch, 1))
    views = np.tile(np.arange(num_cameras, dtype=np.int32), (batch, 1))
    valid = np.ones((batch, num_cameras), bool)
    coord_j = jnp.asarray(coord, jnp.float32)
    dscale, _ = set_scales(cams, 0, wsize, coord_j, jnp.asarray(views),
                           jnp.asarray(valid))
    ray = d / np.linalg.norm(d, axis=1, keepdims=True)
    coord[:, :3] += (rng.uniform(-2, 2, batch)
                     * np.asarray(dscale))[:, None] * ray
    coord_j = jnp.asarray(coord, jnp.float32)
    normal_j = jnp.asarray(normal, jnp.float32)
    prob = make_problem(cams, 0, coord_j, normal_j, jnp.asarray(views),
                        jnp.asarray(valid), dscale, 3)
    return scene, cams, pyr, prob, coord_j, normal_j


def time_call(fn, *args, reps: int = 20) -> float:
    """Median seconds of fn(*args) with block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_evaluator(batch: int = 8192, width: int = 640, height: int = 480,
                    focal: float = 800.0, wsize: int = 7):
    import jax
    from cmvs_pmvs_tpu.ops import incc_reference
    from cmvs_pmvs_tpu.ops.refine import per_view_inccs

    scene, cams, pyr, prob, coord, normal = bench_problem(
        batch, 6, width, height, focal, wsize)
    fn = jax.jit(lambda c, n: per_view_inccs(cams, pyr, 0, wsize, prob,
                                             c, n))
    incc, ref_ok, pair_ok = jax.block_until_ready(fn(coord, normal))
    sec = time_call(fn, coord, normal)
    ri, rok, rpo, decided = incc_reference.per_view_inccs(
        scene.P, pyr.atlas, pyr.widths, pyr.heights, pyr.xoff, 0, wsize,
        coord, normal, prob.views, prob.view_valid)
    po = np.asarray(pair_ok)
    cmp = po & decided
    diff = float(np.abs(np.asarray(incc)[cmp] - ri[cmp]).max())
    agree = float((po == rpo)[decided].mean())
    say(f"[b] evaluator (plain XLA, f32, precision HIGHEST): {batch} "
        f"patches x 6 views, {width}x{height}, wsize {wsize}: "
        f"{sec * 1e3:.3f} ms/call, {batch * 6 / sec / 1e6:.2f} M pair "
        f"evals/s")
    say(f"[b] vs float64 host reference: max |dINCC| {diff:.3e} over "
        f"{int(cmp.sum())} valid pairs ({int((~decided).sum())} pairs at "
        f"a gate threshold excluded), pair validity agreement {agree:.6f}")
    check(cmp.sum() > batch, "too few valid pairs to compare")
    check(diff <= INCC_TOL, f"max |dINCC| {diff:.3e} > {INCC_TOL}")
    check(agree == 1.0, "pair validity differs from the reference")
    return {"ms": sec * 1e3, "max_dincc": diff}


# ------------------------------------------------------------- phase c
def write_scene(root: str, spec: dict, seed: int = 42):
    from cmvs_pmvs_tpu.utils.synthetic import (make_occluded_scene,
                                               write_pmvs_tree)
    scene = make_occluded_scene(num_cameras=spec["num_cameras"],
                                width=spec["width"],
                                height=spec["height"], focal=spec["focal"],
                                seed=seed)
    write_pmvs_tree(scene, root, mask_border=spec["mask_border"])
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write(spec["option"])
    return scene


def surface_error(scene, coord, dscale):
    """Median and p90 of surface distance in dscale units."""
    err = scene.surface_distance(np.asarray(coord)[:, :3]) \
        / np.asarray(dscale)
    return float(np.median(err)), float(np.percentile(err, 90))


def run_pmvs3(root: str, log_path: str) -> float:
    """`pmvs3 root option.txt` through the CLI main; its log goes to
    log_path. Returns wall seconds."""
    from cmvs_pmvs_tpu.cli import pmvs as pmvs_cli
    t0 = time.perf_counter()
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        rc = pmvs_cli.main([root, "option.txt"])
    sec = time.perf_counter() - t0
    check(rc == 0, f"pmvs3 exited {rc} (log {log_path})")
    return sec


def read_outputs(root: str, scene):
    from cmvs_pmvs_tpu.io.patches import read_patch_file
    stem = os.path.join(root, "models", "option.txt")
    for ext in (".patch", ".ply", ".pset"):
        check(os.path.exists(stem + ext), f"missing output {stem + ext}")
    recs = read_patch_file(stem + ".patch")
    check(len(recs) > 0, "pmvs3 wrote no patches")
    coord = np.array([r.coord for r in recs])
    dscale = np.array([r.dscale for r in recs])
    p50, p90 = surface_error(scene, coord, dscale)
    with open(stem + ".trace.json") as f:
        trace = json.load(f)
    phases = {k: round(v["seconds"], 2) for k, v in trace.items()
              if "." not in k}
    return len(recs), p50, p90, phases


def phase_main_path(work: str, events: CacheEvents, spec: dict = FULL):
    import jax
    from cmvs_pmvs_tpu.utils.cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    say(f"[c] compile cache: {cache_dir}")
    result = {}
    for label in ("cold", "warm", "steady"):
        if label == "warm":
            # a second pmvs3 process: no program in memory, every
            # executable from the persistent cache
            jax.clear_caches()
        # "steady": the same process again, every program in memory
        root = os.path.join(work, f"full_{label}")
        scene = write_scene(root, spec)
        before = events.snapshot()
        sec = run_pmvs3(root, os.path.join(work, f"pmvs3_{label}.log"))
        after = events.snapshot()
        hits = after.get("cache_hits", 0) - before.get("cache_hits", 0)
        misses = after.get("cache_misses", 0) \
            - before.get("cache_misses", 0)
        n, p50, p90, phases = read_outputs(root, scene)
        say(f"[c] pmvs3 {label}: {sec:.2f} s, {n} patches, surface error "
            f"p50 {p50:.4f} p90 {p90:.4f} dscale, phases {phases}, "
            f"cache hits {hits} misses {misses}")
        check(p50 < SURFACE_P50_MAX,
              f"median surface error {p50:.4f} >= {SURFACE_P50_MAX}")
        result[label] = dict(seconds=sec, patches=n, p50=p50, hits=hits)
    stats = jax.devices()[0].memory_stats() or {}
    say(f"[c] peak device memory: {stats.get('peak_bytes_in_use', 0)} "
        f"bytes ({stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB)")
    entries = sum(len(fs) for _, _, fs in os.walk(cache_dir))
    say(f"[c] persistent cache holds {entries} files")
    check(entries > 0, f"nothing was written to {cache_dir}")
    check(result["warm"]["hits"] > 0, "the warm run hit no cache entry")
    return result


# ------------------------------------------------------------- phase d
def run_engine(root: str, run_kwargs: dict, p_cap: int = 30000,
               mesh=None):
    from cmvs_pmvs_tpu.models.engine import PMVSEngine, load_scene
    from cmvs_pmvs_tpu.utils.options import PMVSOptions
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    eng = PMVSEngine(load_scene(root, opt), opt, p_cap=p_cap,
                     log=lambda *a: None, mesh=mesh)
    t0 = time.perf_counter()
    eng.run(**run_kwargs)
    alive = np.asarray(eng.cloud.alive)
    sec = time.perf_counter() - t0
    return (int(alive.sum()), np.asarray(eng.cloud.coord)[alive],
            np.asarray(eng.cloud.dscale)[alive], sec)


def phase_two_backends(work: str, spec: dict = SMALL,
                       run_kwargs: dict = SMALL_RUN):
    import jax
    root = os.path.join(work, "small")
    scene = write_scene(root, spec)
    n_gpu, c_gpu, d_gpu, s_gpu = run_engine(root, run_kwargs)
    with jax.default_device(jax.devices("cpu")[0]), no_cache_writes():
        n_cpu, c_cpu, d_cpu, s_cpu = run_engine(root, run_kwargs)
    p_gpu = surface_error(scene, c_gpu, d_gpu)[0]
    p_cpu = surface_error(scene, c_cpu, d_cpu)[0]
    say(f"[d] small e2e scene: gpu {n_gpu} patches (p50 {p_gpu:.4f}, "
        f"{s_gpu:.2f} s incl. compile), cpu {n_cpu} patches (p50 "
        f"{p_cpu:.4f}, {s_cpu:.2f} s incl. compile)")
    check(n_gpu > 0 and abs(n_gpu - n_cpu) <= 0.05 * max(n_gpu, n_cpu),
          f"patch counts differ by more than 5%: gpu {n_gpu}, cpu "
          f"{n_cpu}")


# ------------------------------------------------------------ four cards
# a walk around a courtyard: each of 48 views sees its own stretch of a
# wide textured plane, so CMVS has something to split
RING = dict(num_cameras=48, width=640, height=480, focal=700.0,
            ring_radius=2.0, ring_height=2.0, look_radius=3.0)
RING_BUNDLE = dict(num_points=4000, extent=4.5)


def _cluster_tree(root: str, ring: dict, bundle: dict, maximage: int):
    """View ring + bundle -> cmvs3 (maximage) -> genOption (defaults:
    level 1, csize 2, as the reference's pmvs.sh mode)."""
    from cmvs_pmvs_tpu.cli import cmvs as cmvs_cli
    from cmvs_pmvs_tpu.cli import genoption as gen_cli
    from cmvs_pmvs_tpu.utils.synthetic import (make_plane_scene,
                                               write_bundle_file,
                                               write_pmvs_tree)
    scene = make_plane_scene(**ring)
    write_pmvs_tree(scene, root)
    write_bundle_file(scene, root, **bundle)
    with open(os.devnull, "w") as f, contextlib.redirect_stdout(f):
        check(cmvs_cli.main([root, str(maximage)]) == 0, "cmvs3 failed")
        check(gen_cli.main([root]) == 0, "genOption failed")
    return scene


def _pmvs3_all(root: str, cards: list[int], log_dir: str) -> float:
    """One `pmvs3_all root i n --no-merge` process per card; returns
    wall seconds until the last one ends."""
    t0 = time.perf_counter()
    procs = []
    for i, card in enumerate(cards):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(card),
                   PYTHONPATH=HERE + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        log = open(os.path.join(log_dir, f"pmvs3_all_{len(cards)}_{i}.log"),
                   "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "cmvs_pmvs_tpu.cli.pmvs_all", root,
             str(i), str(len(cards)), "--no-merge"], env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    rcs = []
    for p, log in procs:
        rcs.append(p.wait())
        log.close()
    check(all(rc == 0 for rc in rcs), f"pmvs3_all exit codes {rcs}")
    return time.perf_counter() - t0


def _merged(root: str, scene):
    from cmvs_pmvs_tpu.io.patches import read_patch_file
    from cmvs_pmvs_tpu.parallel.clusters import discover_options, merge_models
    names = discover_options(root)
    stem = merge_models(root, names)
    recs = read_patch_file(stem + ".patch")
    coord = np.array([r.coord for r in recs]).reshape(-1, 4)
    dscale = np.array([r.dscale for r in recs])
    err = scene.plane_distance(coord[:, :3]) / dscale
    return len(names), len(recs), float(np.median(err))


def phase_cluster_placement(work: str, ring: dict = RING,
                            bundle: dict = RING_BUNDLE, maximage: int = 12):
    par = os.path.join(work, "clusters_4")
    scene = _cluster_tree(par, ring, bundle, maximage)
    seq = os.path.join(work, "clusters_1")
    shutil.copytree(par, seq)
    s4 = _pmvs3_all(par, [0, 1, 2, 3], work)
    s1 = _pmvs3_all(seq, [0], work)
    k4, n4, e4 = _merged(par, scene)
    k1, n1, e1 = _merged(seq, scene)
    say(f"[i] {k4} clusters of the {ring['num_cameras']}-view ring: four "
        f"cards {s4:.1f} s, "
        f"{n4} patches, p50 {e4:.4f}; one card {s1:.1f} s, {n1} patches, "
        f"p50 {e1:.4f}")
    check(k4 >= 4, f"cmvs3 made {k4} clusters, expected >= 4")
    check(n4 > 0 and abs(n4 - n1) <= 0.05 * max(n4, n1),
          f"merged clouds differ: {n4} vs {n1} patches")
    check(abs(e4 - e1) <= 0.05, f"p50 {e4:.4f} vs {e1:.4f}")


def phase_sharded_engine(work: str, spec: dict = FULL,
                         run_kwargs: dict | None = None,
                         p_cap: int = 200_000, n_devices: int = 4):
    from cmvs_pmvs_tpu.parallel.engine_shard import make_engine_mesh
    run_kwargs = run_kwargs or {}
    root = os.path.join(work, "sharded")
    scene = write_scene(root, spec)
    n1, c1, d1, s1 = run_engine(root, run_kwargs, p_cap)
    n4, c4, d4, s4 = run_engine(root, run_kwargs, p_cap,
                                mesh=make_engine_mesh(n_devices))
    e1 = surface_error(scene, c1, d1)[0]
    e4 = surface_error(scene, c4, d4)[0]
    say(f"[ii] engine on {spec['num_cameras']} views at {spec['width']}x"
        f"{spec['height']}: one card {n1} patches p50 {e1:.4f} "
        f"({s1:.1f} s incl. compile); {n_devices}-device patch mesh "
        f"{n4} patches p50 {e4:.4f} ({s4:.1f} s incl. compile)")
    check(n4 > 0 and abs(n4 - n1) <= 0.05 * max(n4, n1),
          f"sharded engine {n4} vs one card {n1} patches")
    check(abs(e4 - e1) <= 0.05, f"p50 {e4:.4f} vs {e1:.4f}")


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args(argv)
    from cmvs_pmvs_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four_cards:
            # the cluster processes run first, while this process holds
            # no card (a JAX process reserves most of every card it sees)
            phase_cluster_placement(work)
            devs = phase_device(expect_count=4)
            phase_sharded_engine(work)
        else:
            devs = phase_device()
            events = CacheEvents()
            phase_evaluator()
            phase_main_path(work, events)
            phase_two_backends(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
