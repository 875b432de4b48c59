"""The refine evaluator and what surrounds it on the GPU path.

CPU tests: the plain XLA evaluator against the float64 host reference
(ops/incc_reference.py), bilinear sampling against float64, chunked
window grabs, LM convergence, matmul precision, the compile
cache helper, image loading without PIL and chip_smoke's device gate.
Tests marked `gpu` need the card and skip elsewhere.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmvs_pmvs_tpu.geom import build_camera_set
from cmvs_pmvs_tpu.image import build_pyramids
from cmvs_pmvs_tpu.ops import incc_reference
from cmvs_pmvs_tpu.ops.refine import (
    _patch_axes, make_problem, per_view_inccs, refine_patches, set_scales)
from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 48


def _problem(wsize=7, batch=BATCH, seed=0):
    scene = make_plane_scene(num_cameras=6, width=160, height=120,
                             focal=200.0)
    cams = build_camera_set(scene.P, dtype=jnp.float32)
    pyr = build_pyramids(list(scene.images), None, num_levels=3)
    rng = np.random.default_rng(seed)
    C, P = scene.centers[0], scene.P[0]
    us = rng.uniform(40, 120, batch)
    vs = rng.uniform(30, 90, batch)
    X1 = np.linalg.solve(P[:, :3], np.stack([us, vs, np.ones(batch)])
                         - P[:, 3:4]).T
    d = X1 - C
    s = -(C @ scene.plane_n) / (d @ scene.plane_n)
    pts = C + s[:, None] * d
    coord = jnp.asarray(np.concatenate([pts, np.ones((batch, 1))], 1),
                        jnp.float32)
    normal = jnp.asarray(np.tile(np.append(scene.plane_n, 0.0),
                                 (batch, 1)), jnp.float32)
    views = jnp.tile(jnp.arange(6, dtype=jnp.int32)[None], (batch, 1))
    valid = jnp.ones((batch, 6), bool)
    dscale, _ = set_scales(cams, 0, wsize, coord, views, valid)
    prob = make_problem(cams, 0, coord, normal, views, valid, dscale, 3)
    return scene, cams, pyr, coord, normal, prob, dscale


def _perturbed(cams, coord, dscale, amp, seed):
    ray = coord - cams.center[jnp.zeros(coord.shape[0], jnp.int32)]
    ray = ray / jnp.linalg.norm(ray[:, :3], axis=1, keepdims=True)
    noise = np.random.default_rng(seed).uniform(-amp, amp, coord.shape[0])
    return coord + jnp.asarray(noise, jnp.float32)[:, None] \
        * dscale[:, None] * ray


@pytest.mark.parametrize("wsize", [5, 7, 9])
def test_evaluator_matches_float64_reference(wsize):
    """per_view_inccs (per-sample gather, f32) agrees with the float64
    host reference to 1e-4 on every pair clear of a gate threshold."""
    scene, cams, pyr, coord, normal, prob, dscale = _problem(wsize)
    coord = _perturbed(cams, coord, dscale, 1.0, seed=3)
    incc, ref_ok, pair_ok = per_view_inccs(cams, pyr, 0, wsize, prob,
                                           coord, normal)
    ri, rok, rpo, decided = incc_reference.per_view_inccs(
        scene.P, pyr.atlas, pyr.widths, pyr.heights, pyr.xoff, 0, wsize,
        coord, normal, prob.views, prob.view_valid)
    po = np.asarray(pair_ok)
    assert (po == rpo)[decided].all()
    cmp = po & decided
    assert cmp.sum() > BATCH
    assert np.abs(np.asarray(incc)[cmp] - ri[cmp]).max() <= 1e-4


def test_bilinear_samples_match_float64_bilinear():
    """image/sample.bilinear_color (the 4-tap per-sample gather every
    window grab uses) equals a float64 bilinear lerp of the level's
    pixels, at every pyramid level."""
    from cmvs_pmvs_tpu.image.sample import bilinear_color
    scene, cams, pyr, *_ = _problem(batch=8)
    rng = np.random.default_rng(7)
    m = 500
    n = rng.integers(0, 6, m)
    lv = rng.integers(0, 3, m)
    w = np.asarray(pyr.widths)[lv, n]
    h = np.asarray(pyr.heights)[lv, n]
    x = rng.uniform(0, 1, m) * (w - 2)
    y = rng.uniform(0, 1, m) * (h - 2)
    got = np.asarray(bilinear_color(pyr, jnp.asarray(n), jnp.asarray(lv),
                                    jnp.asarray(x, jnp.float32),
                                    jnp.asarray(y, jnp.float32)))
    atlas = np.asarray(pyr.atlas, np.float64)
    x32 = np.asarray(jnp.asarray(x, jnp.float32), np.float64)
    y32 = np.asarray(jnp.asarray(y, jnp.float32), np.float64)
    lx, ly = np.floor(x32).astype(int), np.floor(y32).astype(int)
    fx, fy = (x32 - lx)[:, None], (y32 - ly)[:, None]
    ax = lx + np.asarray(pyr.xoff)[lv]
    want = (atlas[n, ly, ax] * (1 - fx) * (1 - fy)
            + atlas[n, ly, ax + 1] * fx * (1 - fy)
            + atlas[n, ly + 1, ax] * (1 - fx) * fy
            + atlas[n, ly + 1, ax + 1] * fx * fy)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_grab_masked_chunked_equals_unchunked(monkeypatch):
    """Batches above GRAB_CHUNK run as lax.map chunks (padding the
    last); the result equals the single-pass grab."""
    from cmvs_pmvs_tpu.models import views as V
    scene, cams, pyr, coord, normal, prob, _ = _problem(batch=37)
    ref = prob.views[:, 0]
    vmask = jnp.ones((37, 6), bool)
    one = V.grab_masked(cams, pyr, 0, 7, coord, normal, ref, vmask)
    monkeypatch.setattr(V, "GRAB_CHUNK", 8)
    chunked = V.grab_masked(cams, pyr, 0, 7, coord, normal, ref, vmask)
    assert chunked[0].shape == one[0].shape
    np.testing.assert_array_equal(np.asarray(chunked[1]),
                                  np.asarray(one[1]))
    np.testing.assert_allclose(np.asarray(chunked[0]),
                               np.asarray(one[0]), atol=1e-5)


def test_refine_converges_on_perturbed_plane():
    """The LM loop pulls depth-perturbed patches back onto the plane
    (12 central-difference iterations; at the engine's 8 the median
    offset is still ~0.23 dscale on this scene)."""
    scene, cams, pyr, coord, normal, prob, dscale = _problem()
    coord0 = _perturbed(cams, coord, dscale, 1.5, seed=1)
    prob0 = make_problem(cams, 0, coord0, normal, prob.views,
                         prob.view_valid, dscale, 3)
    c, n, ncc, f = refine_patches(cams, pyr, 0, 7, prob0, coord0, normal,
                                  num_iters=12)
    off = scene.plane_distance(np.asarray(c)[:, :3]) / np.asarray(dscale)
    off0 = scene.plane_distance(np.asarray(coord0)[:, :3]) \
        / np.asarray(dscale)
    assert float(np.median(off)) < 0.15
    assert float(np.median(off)) < 0.3 * float(np.median(off0))
    assert float(jnp.median(ncc)) > 0.9


def _dot_precisions(fn, *args):
    text = jax.jit(fn).lower(*args).as_text()
    lines = [ln for ln in text.splitlines() if "dot_general" in ln]
    return lines, [ln for ln in lines if "HIGHEST" not in ln]


@pytest.mark.parametrize("site", ["project", "cell_of", "encode_params",
                                  "pairwise_texture_dots"])
def test_contractions_request_highest_precision(site):
    """Every f32 dot_general of the projection, parameter and texture
    contractions carries precision HIGHEST (a GPU may otherwise run
    them in TF32)."""
    from cmvs_pmvs_tpu.geom.cameras import project
    from cmvs_pmvs_tpu.models import views as V
    from cmvs_pmvs_tpu.models.grid import cell_of
    from cmvs_pmvs_tpu.ops.refine import encode_params
    scene, cams, pyr, coord, normal, prob, _ = _problem(batch=8)
    if site == "project":
        fn, args = (lambda c: project(cams.P[prob.views], c[:, None], 0),
                    (coord,))
    elif site == "cell_of":
        fn, args = (lambda c: cell_of(cams, 0, 2, c[:, None], prob.views),
                    (coord,))
    elif site == "encode_params":
        fn, args = (lambda c: encode_params(cams, prob, c, normal),
                    (coord,))
    else:
        fn, args = (lambda c: V.set_ref_image(
            cams, pyr, 0, 7, 6, c, normal, prob.views[:, 0],
            jnp.ones((8, 6), bool)), (coord,))
    lines, bad = _dot_precisions(fn, *args)
    assert lines, "no dot_general lowered"
    assert not bad, bad[:2]


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as is and no
    directory is set in code; otherwise <checkout>/.jax_cache."""
    from cmvs_pmvs_tpu.utils import cache
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in updates
    else:
        monkeypatch.delenv(cache.ENV_VAR, raising=False)
        path = cache.enable_compile_cache()
        assert path == os.path.join(_REPO, ".jax_cache")
        assert updates["jax_compilation_cache_dir"] == path
    assert "jax_persistent_cache_min_compile_time_secs" not in updates
    cache.enable_compile_cache(read_only=True)
    assert updates["jax_persistent_cache_min_compile_time_secs"] >= 1e9


@pytest.mark.parametrize("kind", ["P4", "P5", "P6"])
def test_pnm_loading_without_pil(kind, monkeypatch, tmp_path):
    """Binary PBM/PGM/PPM load with PIL unimportable."""
    from cmvs_pmvs_tpu.io import images as I
    monkeypatch.setitem(sys.modules, "PIL", None)
    rng = np.random.default_rng(0)
    path = str(tmp_path / "img")
    if kind == "P6":
        img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
        I.save_ppm(path, img)
        np.testing.assert_array_equal(I.load_image(path), img)
        assert I.image_size(path) == (13, 9)
        return
    mask = rng.integers(0, 2, (9, 13)).astype(np.uint8)
    if kind == "P5":
        I.save_pgm(path, mask)
    else:   # PBM bits: 1 = black = out of mask
        with open(path, "wb") as f:
            f.write(b"P4\n# comment\n13 9\n"
                    + np.packbits(1 - mask, axis=1).tobytes())
    np.testing.assert_array_equal(I.load_pgm_mask(path), mask)
    np.testing.assert_array_equal(I.load_image(path)[..., 1], mask * 255)
    (tmp_path / "x.png").write_bytes(b"\x89PNG....")
    with pytest.raises(ImportError, match="Pillow"):
        I.load_image(str(tmp_path / "x.png"))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    """On a CPU backend chip_smoke.py exits non-zero and prints no
    result line."""
    out = _run_smoke(_REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not 'gpu'" in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied away from the package, chip_smoke.py fails and prints no
    result line."""
    with open(os.path.join(_REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU backend (run with "
                    "JAX_PLATFORMS=cuda,cpu pytest -m gpu)")
    return jax.devices()[0]


@pytest.mark.gpu
def test_evaluator_on_gpu_matches_float64_reference(gpu):
    """The compiled GPU evaluator at a real width (640x480, 1,024
    patches x 6 views) against the float64 host reference."""
    sys.path.insert(0, _REPO)
    import chip_smoke
    out = chip_smoke.phase_evaluator(batch=1024)
    assert out["max_dincc"] <= 1e-4
