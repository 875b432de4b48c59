"""Fine-grained phase timing of the e2e scene (or the full protocol with
--full): host-clock seconds per jitted phase, then per filter sub-pass.
Run: python scripts/profile_e2e.py [--full]"""
import functools
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from cmvs_pmvs_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import numpy as np

from cmvs_pmvs_tpu.models.engine import PMVSEngine, load_scene, _bucket15
from cmvs_pmvs_tpu.utils.options import PMVSOptions
from cmvs_pmvs_tpu.utils.synthetic import make_occluded_scene, write_pmvs_tree

FULL = "--full" in sys.argv
root = tempfile.mkdtemp(prefix="prof_")
if FULL:
    scene = make_occluded_scene(num_cameras=12, width=640, height=480,
                                focal=700.0)
    write_pmvs_tree(scene, root, mask_border=8)
    option = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
              "CPU 4\nsetEdge 0.4\nuseBound 0\nuseVisData 0\nsequence -1\n"
              "timages -1 0 12\noimages 0\n")
else:
    scene = make_occluded_scene(num_cameras=8, width=192, height=144,
                                focal=300.0)
    write_pmvs_tree(scene, root)
    option = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
              "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
              "timages -1 0 8\noimages 0\n")
opt_path = os.path.join(root, "option.txt")
with open(opt_path, "w") as f:
    f.write(option)
opt = PMVSOptions.parse(opt_path)
data = load_scene(root, opt)

TIMES = {}


def wrap(mod, name):
    fn = getattr(mod, name)

    @functools.wraps(fn)
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        jax.block_until_ready(out)
        TIMES[name] = TIMES.get(name, 0.0) + (time.perf_counter() - t0)
        TIMES[name + "#n"] = TIMES.get(name + "#n", 0) + 1
        return out

    setattr(mod, name, wrapped)


import cmvs_pmvs_tpu.models.filter as filt
import cmvs_pmvs_tpu.models.seed as seedm
import cmvs_pmvs_tpu.models.expand as expm

# host-level jit units (resolved at call time via module globals / local
# imports in engine.py)
for nm in ["refresh_visibility", "run_filters_pre", "run_filters_post",
           "run_filters_tail", "count_neighbor_pairs"]:
    wrap(filt, nm)
for nm in ["seed_discover", "seed_commit"]:
    wrap(seedm, nm)
for nm in ["expand_discover", "expand_commit"]:
    wrap(expm, nm)
# engine.py binds expand_* at module import time - wrap its bindings too
import cmvs_pmvs_tpu.models.engine as engm
for nm in ["expand_discover", "expand_commit"]:
    wrap(engm, nm)

if FULL:
    kw = dict(expand_iters=3, max_waves=12, refine_iters=8)
    trials, p_cap = 1, 200_000
else:
    kw = dict(expand_iters=1, max_waves=2, refine_iters=8)
    trials, p_cap = 2, 30000
for trial in range(trials):
    TIMES.clear()
    t0 = time.time()
    eng = PMVSEngine(data, opt, p_cap=p_cap, log=lambda *a: None)
    eng.run(**kw)
    total = time.time() - t0
n = int(np.asarray(eng.cloud.alive).sum())
print(f"total {total:.2f}s patches {n} -> {n/total:.0f}/s")
for k in sorted(TIMES):
    if k.endswith("#n"):
        continue
    print(f"  {k:24s} {TIMES[k]:7.3f}s  x{TIMES[k + '#n']}")
phases = {}
for name, sp in eng.tracer.spans.items():
    top = name.split(".")[0]
    phases[top] = round(phases.get(top, 0.0) + sp.seconds, 2)
print("phases:", phases)

# ---- filter sub-pass breakdown on the final state ----
cloud, grid = eng.cloud, eng.grid
cfg, thr = eng.cfg, eng.thr
cams, pyr = eng.scene.cams, eng.scene.pyr
cap_b = eng._cap_bucket(int(cloud.count()))
cl = eng._slice(cap_b)

subs = {}
def timeit(name, fn, *a, **k):
    out = fn(*a, **k)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(*a, **k)
    jax.block_until_ready(out)
    subs[name] = time.perf_counter() - t0
    return out

rv = filt.refresh_visibility
cl2, grid2 = timeit("refresh_visibility", rv, cams, pyr, cfg, thr, cl, grid)
jfo = jax.jit(filt.filter_outside, static_argnames=("cfg",))
timeit("filter_outside", jfo, cams, cfg, thr, cl2, grid2)
jfe = jax.jit(filt.filter_exact, static_argnames=("cfg",))
timeit("filter_exact", jfe, cams, pyr, cfg, thr, cl2, grid2)
need = int(filt.count_neighbor_pairs(cfg, cl2))
pb = _bucket15(max(need, 1024), 1 << 28)
jfn = jax.jit(filt.filter_neighbor, static_argnames=("cfg", "pair_budget"))
timeit("filter_neighbor", jfn, cams, cfg, thr, cl2, grid2, pb)
jfg = jax.jit(filt.filter_small_groups, static_argnames=("cfg",))
timeit("filter_small_groups", jfg, cams, cfg, thr, cl2, grid2)
for k, v in subs.items():
    print(f"  sub {k:22s} {v*1000:7.1f}ms")
