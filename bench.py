"""GPU benchmark: refine throughput and end-to-end reconstruction.

    python bench.py

Prints ONE JSON line naming the device it ran on (platform, kind,
count, and the card's name and power limit from nvidia-smi) with:
  * kernel: full Levenberg-Marquardt refinements/s of 8,192 patches x 6
    views at 640x480, wsize 7, NUM_ITERS iterations (the engine
    default), timed with block_until_ready; objective evaluations/s on
    the same basis, and that rate over a 16-core CPU running the
    reference's hot loop (vs_baseline_equal_work, BASELINE.md), with
    the source of the CPU figure;
  * e2e / full: the small e2e scene and the full reference protocol
    through PMVSEngine, cold (compiling) and warm, with patch count,
    median surface error and per-phase seconds.
A stage that fails raises, and the script exits non-zero. It needs a
GPU backend and fails without one.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402

BATCH = 8192
NUM_ITERS = 8
# objective evaluations per refinement of the central-difference LM
# loop (ops/refine.refine_patches): the initial point, then per
# iteration 6 probes + the candidate, then the final weighted score
EVALS_PER_REFINEMENT = 1 + 7 * NUM_ITERS + 1
# reference hot loop on one CPU core (BASELINE.md, round-3 build host)
RECORDED_EVALS_PER_SEC_PER_CORE = 193092.0
BASELINE_CORES = 16


def cpu_baseline_evals_per_sec() -> tuple[float, str]:
    """16-core objective evals/s of the reference hot loop and where
    the figure came from: measured here by native/cpu_baseline when it
    is built (native/build.sh), else the recorded BASELINE.md figure."""
    exe = os.path.join(HERE, "native", "cpu_baseline")
    if os.path.exists(exe):
        out = subprocess.run([exe, "1", "4"], capture_output=True,
                             text=True, timeout=60, check=True)
        eps = float(json.loads(out.stdout)["evals_per_sec"])
        return eps * BASELINE_CORES, \
            f"measured on this host by native/cpu_baseline x " \
            f"{BASELINE_CORES} cores"
    return RECORDED_EVALS_PER_SEC_PER_CORE * BASELINE_CORES, \
        "recorded BASELINE.md figure (2.1 GHz Xeon build host, 1 core " \
        f"x {BASELINE_CORES}); native/cpu_baseline not built"


def bench_kernel() -> float:
    """Refinements/s of the jitted refine step at the bench shape."""
    import jax
    from cmvs_pmvs_tpu.ops.refine import refine_patches
    scene, cams, pyr, prob, coord, normal = cs.bench_problem(BATCH)
    fn = jax.jit(lambda c, n: refine_patches(
        cams, pyr, 0, 7, prob, c, n, num_iters=NUM_ITERS)[:3])
    return BATCH / cs.time_call(fn, coord, normal, reps=5)


def bench_scene(tag: str, spec: dict, run_kwargs: dict, p_cap: int):
    """Cold then warm PMVSEngine run of one generated scene."""
    from cmvs_pmvs_tpu.models.engine import PMVSEngine, load_scene
    from cmvs_pmvs_tpu.utils.options import PMVSOptions
    root = tempfile.mkdtemp(prefix=f"bench_{tag}_")
    scene = cs.write_scene(root, spec)
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt)
    out = {}
    for label in ("cold", "warm"):
        eng = PMVSEngine(data, opt, p_cap=p_cap, log=lambda *a: None)
        t0 = time.perf_counter()
        eng.run(**run_kwargs)
        alive = np.asarray(eng.cloud.alive)
        out[f"{tag}_{label}_seconds"] = time.perf_counter() - t0
    p50, p90 = cs.surface_error(scene, np.asarray(eng.cloud.coord)[alive],
                                np.asarray(eng.cloud.dscale)[alive])
    phases = {}
    for name, sp in eng.tracer.spans.items():
        top = name.split(".")[0]
        phases[top] = phases.get(top, 0.0) + sp.seconds
    out.update({f"{tag}_patches": int(alive.sum()),
                f"{tag}_surface_p50_dscale": p50,
                f"{tag}_surface_p90_dscale": p90,
                f"{tag}_warm_phase_seconds": phases})
    return out


def main():
    import jax
    from cmvs_pmvs_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    devs = cs.phase_device()
    rps = bench_kernel()
    base, base_src = cpu_baseline_evals_per_sec()
    line = {
        "metric": "patch_refinements_per_sec",
        "value": rps,
        "unit": "refinements/s",
        "objective_evals_per_sec": rps * EVALS_PER_REFINEMENT,
        "vs_baseline_equal_work": rps * EVALS_PER_REFINEMENT / base,
        "baseline_evals_per_sec_16core": base,
        "baseline_source": base_src,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "gpu": cs.gpu_line(),
    }
    line.update(bench_scene("e2e", cs.SMALL, cs.SMALL_RUN, 30000))
    line.update(bench_scene("full", cs.FULL, {}, 200_000))
    stats = jax.devices()[0].memory_stats() or {}
    line["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
