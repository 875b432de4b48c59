"""Real multi-process execution (VERDICT r2 item 4).

Two OS processes - not monkeypatched fakes - drive the two distribution
seams:

  * cluster scheduling: each process reconstructs its round-robin share
    of the option files on a shared tree (the reference's
    one-pmvs2-per-cluster pmvs.sh, source/genOption.cpp:58-74), and the
    merged cloud equals a single-process run of the same clusters;
  * GSPMD engine: jax.distributed (CPU/gloo) with a `patch` mesh spanning
    both processes' devices runs the whole engine, and the result matches
    the unsharded single-process engine.
"""
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene, write_pmvs_tree

_WORKER = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if extra:
        env.update(extra)
    return env


def _spawn(args, extra_env=None):
    return subprocess.Popen([sys.executable, _WORKER, *args],
                            env=_env(extra_env), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _join(procs, timeout=480):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    return outs


def _make_cluster_tree(root: str):
    scene = make_plane_scene(num_cameras=6, width=128, height=96,
                             focal=180.0)
    write_pmvs_tree(scene, root)
    # two overlapping clusters, enumerated timages/oimages (option-file
    # grammar of reference option.cpp:67-101)
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


def test_two_process_clusters_match_single(tmp_path):
    shared = str(tmp_path / "shared")
    solo = str(tmp_path / "solo")
    _make_cluster_tree(shared)
    shutil.copytree(shared, solo)

    # two concurrent OS processes split the clusters round-robin
    procs = [_spawn(["clusters", shared, "0", "2"]),
             _spawn(["clusters", shared, "1", "2"])]
    _join(procs)

    # single-process oracle over the same two clusters, in-process
    from cmvs_pmvs_tpu.parallel.clusters import merge_models, run_clusters
    run_clusters(solo, process_index=0, process_count=1, p_cap=8192,
                 log=lambda *a: None, expand_iters=1, max_waves=1,
                 refine_iters=4)

    from cmvs_pmvs_tpu.io.patches import read_patch_file
    merged_mp = merge_models(shared)
    merged_sp = merge_models(solo)
    recs_mp = read_patch_file(merged_mp + ".patch")
    recs_sp = read_patch_file(merged_sp + ".patch")
    assert len(recs_mp) > 0
    assert len(recs_mp) == len(recs_sp), (len(recs_mp), len(recs_sp))
    c_mp = np.sort(np.array([r.coord[:3] for r in recs_mp]), axis=0)
    c_sp = np.sort(np.array([r.coord[:3] for r in recs_sp]), axis=0)
    assert np.allclose(c_mp, c_sp, atol=1e-4)

    # resume markers written (elastic-recovery contract)
    for i in range(2):
        assert os.path.exists(
            os.path.join(shared, "models", f"option-{i:04d}.done"))


def test_two_process_gspmd_engine(tmp_path):
    root = str(tmp_path / "scene")
    scene = make_plane_scene(num_cameras=4, width=96, height=72,
                             focal=140.0)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 4\noimages 0\n")

    with socket.socket() as s:      # free port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "mp_count.txt")
    procs = [_spawn(["gspmd", root, str(i), "2",
                     f"localhost:{port}", out]) for i in range(2)]
    _join(procs)
    n_mp = int(open(out).read())

    # unsharded single-process oracle
    from cmvs_pmvs_tpu.models.engine import PMVSEngine, load_scene
    from cmvs_pmvs_tpu.utils.options import PMVSOptions
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt)
    eng = PMVSEngine(data, opt, p_cap=4096, log=lambda *a: None)
    eng.run(expand_iters=1, max_waves=1, refine_iters=4)
    n_sp = int(np.asarray(eng.cloud.alive).sum())

    assert n_mp > 0
    # same tolerance as the single-process GSPMD equality test
    assert abs(n_mp - n_sp) <= max(3, int(0.05 * n_sp)), (n_mp, n_sp)


def test_four_process_gspmd_engine(tmp_path):
    """4 OS processes x 2 virtual devices under jax.distributed/gloo
    (VERDICT r3 item 6: beyond the 2-process evidence): the 8-device
    global mesh spans four processes and the result still matches the
    unsharded engine."""
    root = str(tmp_path / "scene")
    scene = make_plane_scene(num_cameras=4, width=96, height=72,
                             focal=140.0)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 4\noimages 0\n")

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "mp4_count.txt")
    procs = [_spawn(["gspmd", root, str(i), "4",
                     f"localhost:{port}", out],
                    extra_env={"MP_DEVICES": "2"}) for i in range(4)]
    _join(procs, timeout=900)
    n_mp = int(open(out).read())

    from cmvs_pmvs_tpu.models.engine import PMVSEngine, load_scene
    from cmvs_pmvs_tpu.utils.options import PMVSOptions
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt)
    eng = PMVSEngine(data, opt, p_cap=4096, log=lambda *a: None)
    eng.run(expand_iters=1, max_waves=1, refine_iters=4)
    n_sp = int(np.asarray(eng.cloud.alive).sum())

    assert n_mp > 0
    assert abs(n_mp - n_sp) <= max(3, int(0.05 * n_sp)), (n_mp, n_sp)
