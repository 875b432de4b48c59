"""Fault injection + elastic recovery (VERDICT r2 weak item: SURVEY
section 5.3/5.4 - the reference's only failure handling is exit(1) and a
never-called readPatches resume path, patchOrganizerS.cpp:134-205).

Two recovery seams are driven by real faults here:

  * cluster level: an OS worker process is SIGKILLed mid-run (after its
    first cluster's completion marker appears, i.e. while the second
    cluster is reconstructing); a rerun skips the completed cluster,
    re-does the interrupted one, and the merged cloud equals a clean
    uninterrupted run;
  * engine level: a reconstruction checkpointed after iteration 1 and
    resumed in a fresh engine (run(start_iter=1)) produces the same
    cloud as the uninterrupted 2-iteration run.
"""
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene, write_pmvs_tree

_WORKER = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _make_cluster_tree(root: str):
    scene = make_plane_scene(num_cameras=6, width=128, height=96,
                             focal=180.0)
    write_pmvs_tree(scene, root)
    opts = ["timages 3 0 1 2\noimages 1 3\n",
            "timages 3 3 4 5\noimages 1 2\n"]
    for i, tail in enumerate(opts):
        with open(os.path.join(root, f"option-{i:04d}"), "w") as f:
            f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\n"
                    "minImageNum 3\nCPU 4\nsetEdge 0\nuseBound 0\n"
                    "useVisData 0\nsequence -1\n" + tail)
    with open(os.path.join(root, "pmvs.sh"), "w") as f:
        f.write("pmvs2 ./ option-0000\npmvs2 ./ option-0001\n")
    return scene


def test_cluster_worker_sigkill_then_resume(tmp_path):
    shared = str(tmp_path / "shared")
    solo = str(tmp_path / "solo")
    _make_cluster_tree(shared)
    shutil.copytree(shared, solo)
    done0 = os.path.join(shared, "models", "option-0000.done")
    done1 = os.path.join(shared, "models", "option-0001.done")

    # one worker owns both clusters; kill it the moment cluster 0's
    # completion marker lands (cluster 1 is then mid-reconstruction)
    proc = subprocess.Popen(
        [sys.executable, _WORKER, "clusters", shared, "0", "1"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.time() + 420
    while not os.path.exists(done0):
        assert proc.poll() is None, proc.communicate()[0][-2000:]
        assert time.time() < deadline, "cluster 0 never completed"
        time.sleep(0.1)
    was_midrun = not os.path.exists(done1)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=60)
    assert proc.returncode != 0          # it really died
    assert was_midrun                    # ...while cluster 1 was running

    # recovery: a fresh worker skips the finished cluster and re-runs
    # the interrupted one (any partial models/option-0001.* from the
    # killed process are simply overwritten)
    out = subprocess.run(
        [sys.executable, _WORKER, "clusters", shared, "0", "1"],
        env=_env(), capture_output=True, text=True, timeout=480)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert os.path.exists(done1)

    # clean uninterrupted oracle on an identical tree
    from cmvs_pmvs_tpu.parallel.clusters import merge_models, run_clusters
    run_clusters(solo, process_index=0, process_count=1, p_cap=8192,
                 log=lambda *a: None, expand_iters=1, max_waves=1,
                 refine_iters=4)
    from cmvs_pmvs_tpu.io.patches import read_patch_file
    recs_f = read_patch_file(merge_models(shared) + ".patch")
    recs_s = read_patch_file(merge_models(solo) + ".patch")
    assert len(recs_f) > 0
    assert len(recs_f) == len(recs_s), (len(recs_f), len(recs_s))
    c_f = np.sort(np.array([r.coord[:3] for r in recs_f]), axis=0)
    c_s = np.sort(np.array([r.coord[:3] for r in recs_s]), axis=0)
    assert np.allclose(c_f, c_s, atol=1e-4)


def test_midrun_checkpoint_resume_equals_uninterrupted(tmp_path):
    root = str(tmp_path / "scene")
    scene = make_plane_scene(num_cameras=5, width=96, height=72,
                             focal=140.0)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 5\noimages 0\n")
    from cmvs_pmvs_tpu.models.engine import PMVSEngine, load_scene
    from cmvs_pmvs_tpu.utils.options import PMVSOptions
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt)
    kw = dict(max_waves=2, refine_iters=4)

    # uninterrupted 2-iteration oracle
    eng_a = PMVSEngine(data, opt, p_cap=8192, log=lambda *a: None)
    eng_a.run(expand_iters=2, **kw)

    # "crashed" run: stop after iteration 1, checkpoint, resume in a
    # FRESH engine (nothing carried over but the npz)
    eng_b = PMVSEngine(data, opt, p_cap=8192, log=lambda *a: None)
    eng_b.run(expand_iters=1, **kw)
    ckpt = os.path.join(root, "state.npz")
    eng_b.save_checkpoint(ckpt, iteration=1)
    del eng_b

    eng_c = PMVSEngine(data, opt, p_cap=8192, log=lambda *a: None)
    assert eng_c.load_checkpoint(ckpt) == 1
    eng_c.run(expand_iters=2, start_iter=1, **kw)

    a_alive = np.asarray(eng_a.cloud.alive)
    c_alive = np.asarray(eng_c.cloud.alive)
    n_a, n_c = int(a_alive.sum()), int(c_alive.sum())
    assert n_a > 0
    assert n_a == n_c, (n_a, n_c)
    c_a = np.sort(np.asarray(eng_a.cloud.coord)[a_alive][:, :3], axis=0)
    c_c = np.sort(np.asarray(eng_c.cloud.coord)[c_alive][:, :3], axis=0)
    np.testing.assert_allclose(c_a, c_c, atol=1e-5)
