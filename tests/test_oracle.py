"""Engine-vs-oracle aggregate equivalence (VERDICT r3 missing 2).

Runs the sequential reference-semantics oracle (tests/oracle_pmvs.py -
first-2-successes seeding, priority-queue expansion, mutable cell
counters, scipy-Powell refinement of my_f) and the batched engine
on the same tiny synthetic scene with the same detected features, then
compares the CLOUDS at the aggregate level (SURVEY.md section 7: the
reference's order-dependent rules make patch-for-patch comparison
meaningless; completeness/accuracy are the contract).
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp

from cmvs_pmvs_tpu.models.engine import PMVSEngine, load_scene
from cmvs_pmvs_tpu.utils.options import PMVSOptions
from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene, write_pmvs_tree

from oracle_pmvs import OraclePMVS

W, H, NCAM, FOCAL = 96, 72, 5, 130.0
FEAT_CAP = 48     # strongest features per image fed to BOTH sides


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("oracle"))
    scene = make_plane_scene(num_cameras=NCAM, width=W, height=H,
                             focal=FOCAL)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\n"
                "minImageNum 3\nCPU 4\nsetEdge 0\nuseBound 0\n"
                "useVisData 0\nsequence -1\n"
                f"timages -1 0 {NCAM}\noimages 0\n")
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt)

    # one shared feature set for both sides
    from cmvs_pmvs_tpu.ops.detect import detect_features
    pyr = data.pyr
    h = int(np.asarray(pyr.heights[0]).max())
    w = int(np.asarray(pyr.widths[0]).max())
    x0 = int(pyr.xoff[0])
    img = pyr.atlas[:, :h, x0:x0 + w, :]
    mask = pyr.mask_atlas[:, :h, x0:x0 + w] \
        * pyr.edge_atlas[:, :h, x0:x0 + w]
    feats = detect_features(img, mask, pyr.widths[0], pyr.heights[0],
                            fcsize=16)
    # cap at the FEAT_CAP strongest per image, mirrored into both
    # representations (dict-of-arrays for the engine, per-image lists
    # for the oracle)
    fx = np.asarray(feats["x"])
    fy = np.asarray(feats["y"])
    fr = np.asarray(feats["response"])
    ft = np.asarray(feats["type"])
    fv = np.asarray(feats["valid"])
    order = np.argsort(np.where(fv, -fr, np.inf), axis=1)[:, :FEAT_CAP]
    take = lambda a: np.take_along_axis(a, order, axis=1)
    fx, fy, fr, ft, fv = map(take, (fx, fy, fr, ft, fv))
    feats_eng = {"x": jnp.asarray(fx), "y": jnp.asarray(fy),
                 "response": jnp.asarray(fr), "type": jnp.asarray(ft),
                 "valid": jnp.asarray(fv)}
    feats_orc = [
        [(float(fx[i, k]), float(fy[i, k]), float(fr[i, k]),
          int(ft[i, k])) for k in range(fx.shape[1]) if fv[i, k]]
        for i in range(NCAM)]
    return scene, data, opt, feats_eng, feats_orc


def _metrics(scene, coords, dscales, tn, cams_P, csize):
    """(median plane offset in dscale units, set of covered ref cells)."""
    off = np.abs(scene.plane_distance(coords[:, :3])) / dscales
    covered = set()
    for i in range(tn):
        q = (np.asarray(cams_P)[i] @ np.concatenate(
            [coords[:, :3], np.ones((len(coords), 1))], 1).T)
        ok = q[2] > 0
        x = q[0, ok] / q[2, ok]
        y = q[1, ok] / q[2, ok]
        for cx, cy in zip((x // csize).astype(int),
                          (y // csize).astype(int)):
            covered.add((i, cx, cy))
    return float(np.median(off)), covered


def test_engine_matches_oracle_aggregates(setup):
    scene, data, opt, feats_eng, feats_orc = setup

    # ---- oracle: sequential reference walk ----
    orc = OraclePMVS(list(scene.images), scene.P, csize=opt.csize,
                     wsize=opt.wsize, threshold=opt.threshold,
                     min_image_num=opt.min_image_num)
    orc.run_seed(feats_orc)
    n_seed_orc = len(orc.patches)
    assert n_seed_orc > 10, "oracle seeding produced too few patches"
    orc.run_expand()
    n_orc = len(orc.patches)
    assert n_orc > n_seed_orc, "oracle expansion added nothing"
    oc = np.stack([p.coord for p in orc.patches])
    od = np.array([p.dscale for p in orc.patches])
    acc_orc, cov_orc = _metrics(scene, oc, od, orc.tn, scene.P,
                                opt.csize)

    # ---- engine: batched waves on the same features ----
    eng = PMVSEngine(data, opt, p_cap=16384, log=lambda *a: None)
    # drive run() with the shared features by monkey-patching detect
    import cmvs_pmvs_tpu.models.engine as E
    orig = E.detect_features
    E.detect_features = lambda *a, **k: feats_eng
    try:
        eng.run(expand_iters=1, max_waves=12, refine_iters=8,
                filters=False)
    finally:
        E.detect_features = orig
    alive = np.asarray(eng.cloud.alive)
    ec = np.asarray(eng.cloud.coord)[alive]
    ed = np.asarray(eng.cloud.dscale)[alive]
    n_eng = len(ec)
    acc_eng, cov_eng = _metrics(scene, ec, ed, eng.cfg.tn, scene.P,
                                opt.csize)

    # ---- aggregate comparison ----
    # accuracy: both clouds lie on the plane within a fraction of a
    # depth step; the engine must not be materially worse
    assert acc_orc < 0.35, acc_orc
    assert acc_eng < 0.35, acc_eng
    assert acc_eng < max(2.0 * acc_orc, 0.2), (acc_eng, acc_orc)

    # completeness: covered reference-image cells within 35% of the
    # oracle's, and substantial overlap of the covered sets
    assert len(cov_eng) > 0.65 * len(cov_orc), \
        (len(cov_eng), len(cov_orc))
    inter = len(cov_eng & cov_orc)
    assert inter > 0.55 * len(cov_orc), (inter, len(cov_orc))

    # patch count within a factor 2 (wave dedup keeps one patch per
    # cell per wave; the sequential walk can stack more)
    assert 0.5 * n_orc < n_eng < 2.0 * n_orc, (n_eng, n_orc)


def test_engine_matches_oracle_with_filters(setup):
    """Seed -> expand -> filterOutside+filterNeighbor on both sides
    (VERDICT r4 item 6: the oracle now covers the filter stage; bounds
    ratcheted to the measured margins with headroom)."""
    scene, data, opt, feats_eng, feats_orc = setup

    orc = OraclePMVS(list(scene.images), scene.P, csize=opt.csize,
                     wsize=opt.wsize, threshold=opt.threshold,
                     min_image_num=opt.min_image_num)
    orc.run_seed(feats_orc)
    orc.run_expand()
    n_pre = len(orc.patches)
    orc.run_filters(quad=opt.quad_threshold)
    n_orc = len(orc.patches)
    assert n_orc > 10, n_orc
    oc = np.stack([p.coord for p in orc.patches])
    od = np.array([p.dscale for p in orc.patches])
    acc_orc, cov_orc = _metrics(scene, oc, od, orc.tn, scene.P,
                                opt.csize)

    eng = PMVSEngine(data, opt, p_cap=16384, log=lambda *a: None)
    import cmvs_pmvs_tpu.models.engine as E
    orig = E.detect_features
    E.detect_features = lambda *a, **k: feats_eng
    try:
        eng.run(expand_iters=1, max_waves=12, refine_iters=8,
                filters=True)
    finally:
        E.detect_features = orig
    alive = np.asarray(eng.cloud.alive)
    ec = np.asarray(eng.cloud.coord)[alive]
    ed = np.asarray(eng.cloud.dscale)[alive]
    n_eng = len(ec)
    acc_eng, cov_eng = _metrics(scene, ec, ed, eng.cfg.tn, scene.P,
                                opt.csize)
    print(f"[oracle-filters] orc {n_pre}->{n_orc} acc {acc_orc:.3f} "
          f"cov {len(cov_orc)}; eng {n_eng} acc {acc_eng:.3f} "
          f"cov {len(cov_eng)} inter {len(cov_eng & cov_orc)}")

    # neither side's filters may gut the cloud (the clean plane scene
    # has no outliers: the oracle keeps 723/723; junk rejection is
    # pinned by test_oracle_filters_reject_junk below and the per-pass
    # parity tests in test_filter_neighbor.py)
    assert n_orc > 0.6 * n_pre, (n_orc, n_pre)
    # accuracy: surviving clouds sit on the plane
    assert acc_orc < 0.35, acc_orc
    assert acc_eng < 0.35, acc_eng
    assert acc_eng < max(2.0 * acc_orc, 0.2), (acc_eng, acc_orc)
    # completeness, ratcheted to measured margins + headroom (measured
    # 2026-08-21: cov_eng/cov_orc = 1.50, inter/cov_orc = 0.84,
    # n_eng/n_orc = 1.70)
    assert len(cov_eng) > 0.8 * len(cov_orc), \
        (len(cov_eng), len(cov_orc))
    inter = len(cov_eng & cov_orc)
    assert inter > 0.7 * len(cov_orc), (inter, len(cov_orc))
    # count within 1.9x either way (wave dedup vs sequential stacking)
    assert n_orc / 1.9 < n_eng < 1.9 * n_orc, (n_eng, n_orc)


def test_oracle_filters_reject_junk(setup):
    """Injected off-surface junk must die in the oracle's
    filterOutside/filterNeighbor while the true cloud survives."""
    scene, data, opt, feats_eng, feats_orc = setup
    from oracle_pmvs import OPatch
    orc = OraclePMVS(list(scene.images), scene.P, csize=opt.csize,
                     wsize=opt.wsize, threshold=opt.threshold,
                     min_image_num=opt.min_image_num)
    orc.run_seed(feats_orc)
    orc.run_expand()
    n_real = len(orc.patches)
    rng = np.random.default_rng(3)
    junk = []
    for k in range(40):
        src = orc.patches[rng.integers(0, n_real)]
        coord = src.coord.copy()
        # push the patch far off the surface along its normal: a
        # lonely floater with no coplanar support
        coord[:3] += src.normal[:3] * (30.0 + 10 * k) * src.dscale
        pat = OPatch(coord=coord, normal=src.normal.copy(),
                     ncc=min(src.ncc, 0.75), images=list(src.images),
                     dscale=src.dscale, ascale=src.ascale)
        junk.append(pat)
        orc.add_patch(pat)
    orc.run_filters(quad=opt.quad_threshold)
    junk_ids = {id(j) for j in junk}
    kept_junk = sum(1 for p in orc.patches if id(p) in junk_ids)
    assert kept_junk <= 4, kept_junk
    assert len(orc.patches) - (40 - kept_junk) >= 0.6 * n_real
