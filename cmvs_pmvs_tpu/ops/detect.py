"""Harris + Difference-of-Gaussians feature detection as batched XLA convs.

Batched port of the reference detector stack (source/pmvs/harris.cpp,
dog.cpp, detector.cpp, detectFeatures.cpp): all N views are processed as one
[N, H, W, 3] batch; the per-32px-bucket top-4 selection becomes a reshaped
top-k.

Faithfulness notes:
  * Harris: 3-tap central derivative + 3-tap box prefilter, structure
    tensor summed over RGB, sigma=4 Gaussian integration, response
    det - 0.06 tr^2, 4-neighbor strict NMS (harris.cpp:114-171).
  * DoG: Gaussian scale space of RGB norms, step sqrt(2), scales 1->3,
    3x3 spatial + center-only scale local extrema, first-scale-wins
    dedup (dog.cpp:96-198).
  * Selection: per (gspeedup*2)^2-pixel bucket keep the 4 strongest, skip
    a detector-margin border (harris.cpp:192-237, dog.cpp:115-184).
  * Border handling: reference unmasked convolutions skip out-of-range
    taps (zero padding); its masked variant clamps indices instead. We use
    zero padding everywhere; detection margins exclude the affected border
    rows/cols except for the sigma=4 blur tails, which only perturb
    responses within 8px of the border (bucket selection there is rare).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def gauss_kernel(sigma: float) -> np.ndarray:
    """Normalized Gaussian taps, margin ceil(2 sigma)
    (reference detector.cpp:29-47)."""
    margin = int(math.ceil(2 * sigma))
    xs = np.arange(-margin, margin + 1, dtype=np.float64)
    g = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _sep_conv(img: jnp.ndarray, kx: np.ndarray | None,
              ky: np.ndarray | None) -> jnp.ndarray:
    """Separable correlation with zero padding. img: [N, H, W, C]."""
    c = img.shape[-1]
    out = img
    if kx is not None:
        k = jnp.asarray(kx, img.dtype).reshape(1, -1, 1, 1)
        k = jnp.tile(k, (1, 1, 1, c))
        out = jax.lax.conv_general_dilated(
            out, k, (1, 1), [(0, 0), (len(kx) // 2,) * 2],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=c)
    if ky is not None:
        k = jnp.asarray(ky, img.dtype).reshape(-1, 1, 1, 1)
        k = jnp.tile(k, (1, 1, 1, c))
        out = jax.lax.conv_general_dilated(
            out, k, (1, 1), [(len(ky) // 2,) * 2, (0, 0)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=c)
    return out


DERIV3 = np.array([-0.5, 0.0, 0.5], np.float32)
BOX3 = np.array([1.0 / 3.0] * 3, np.float32)


def harris_response(img: jnp.ndarray, mask: jnp.ndarray,
                    sigma: float = 4.0) -> jnp.ndarray:
    """Harris corner response with 4-neighbor NMS applied.

    img: [N, H, W, 3] float in [0, 255]; mask: [N, H, W] (0/1).
    Returns [N, H, W] responses, 0 at suppressed/masked pixels.
    """
    I = img / 255.0 * mask[..., None]
    dIdx = _sep_conv(I, DERIV3, BOX3)
    dIdy = _sep_conv(I, BOX3, DERIV3)
    dxx = (dIdx * dIdx).sum(-1, keepdims=True)
    dyy = (dIdy * dIdy).sum(-1, keepdims=True)
    dxy = (dIdx * dIdy).sum(-1, keepdims=True)
    g = gauss_kernel(sigma)
    prods = jnp.concatenate([dxx, dyy, dxy], axis=-1) * mask[..., None]
    prods = _sep_conv(prods, g, g)
    dxx, dyy, dxy = prods[..., 0], prods[..., 1], prods[..., 2]
    det = dxx * dyy - dxy * dxy
    tr = dxx + dyy
    resp = (det - 0.06 * tr * tr) * mask

    # strict 4-neighbor NMS on interior pixels (harris.cpp:156-171)
    r = jnp.pad(resp, ((0, 0), (1, 1), (1, 1)), constant_values=-jnp.inf)
    keep = ((resp >= r[:, 1:-1, 2:]) & (resp >= r[:, 1:-1, :-2])
            & (resp >= r[:, 2:, 1:-1]) & (resp >= r[:, :-2, 1:-1]))
    interior = jnp.zeros_like(resp, dtype=bool).at[:, 1:-1, 1:-1].set(True)
    keep = keep | ~interior
    return jnp.where(keep, resp, 0.0)


def dog_responses(img: jnp.ndarray, mask: jnp.ndarray,
                  first_scale: float = 1.0, last_scale: float = 3.0
                  ) -> tuple[jnp.ndarray, list[float]]:
    """DoG local-extrema responses per center scale.

    Returns ([S, N, H, W] |cdog| at accepted extrema else 0, scales list)
    following dog.cpp:128-184 (center scales i=2..steps-1, first-scale-wins
    dedup applied by the caller via the scale ordering).
    """
    step = math.sqrt(2.0)
    steps = max(4, int(math.ceil(math.log(last_scale / first_scale)
                                 / math.log(step))))
    I = img / 255.0 * mask[..., None]

    def res(sigma):
        g = gauss_kernel(sigma)
        blurred = _sep_conv(I, g, g)
        return jnp.linalg.norm(blurred, axis=-1)

    sigmas = [first_scale * step ** i for i in range(steps + 2)]
    res_maps = [res(s) for s in sigmas]
    dogs = [res_maps[i + 1] - res_maps[i] for i in range(len(res_maps) - 1)]

    out = []
    cscales = []
    for i in range(2, steps):
        pdog, cdog, ndog = dogs[i - 2], dogs[i - 1], dogs[i]
        cscales.append(first_scale * step ** (i + 1))
        v = cdog
        p = jnp.pad(v, ((0, 0), (1, 1), (1, 1)), constant_values=0.0)
        n8_max = jnp.stack([
            p[:, :-2, :-2], p[:, :-2, 1:-1], p[:, :-2, 2:],
            p[:, 1:-1, :-2], p[:, 1:-1, 2:],
            p[:, 2:, :-2], p[:, 2:, 1:-1], p[:, 2:, 2:]], 0)
        is_max = (v > 0) & jnp.all(n8_max < v[None], 0) \
            & (pdog < v) & (ndog < v)
        is_min = (v <= 0) & jnp.all(n8_max > v[None], 0) \
            & (pdog > v) & (ndog > v)
        interior = jnp.zeros_like(v, bool).at[:, 1:-1, 1:-1].set(True)
        hit = (is_max | is_min) & interior & (v != 0.0) & (mask > 0)
        out.append(jnp.where(hit, jnp.abs(v), 0.0))
    return jnp.stack(out), cscales


def bucket_topk(resp: jnp.ndarray, valid: jnp.ndarray, gridsize: int,
                k: int = 4):
    """Top-k responses per gridsize x gridsize bucket.

    resp/valid: [N, H, W]. Returns (x [N, M], y [N, M], r [N, M],
    ok [N, M]) with M = num_buckets * k, matching the multiset cap in
    harris.cpp:192-237 (bucket index min(x/gridsize, w-1))."""
    n, h, w = resp.shape
    gh, gw = -(-h // gridsize), -(-w // gridsize)
    ph, pw = gh * gridsize, gw * gridsize
    r = jnp.pad(resp, ((0, 0), (0, ph - h), (0, pw - w)))
    v = jnp.pad(valid, ((0, 0), (0, ph - h), (0, pw - w)))
    score = jnp.where(v, r, -jnp.inf)
    score = score.reshape(n, gh, gridsize, gw, gridsize)
    score = score.transpose(0, 1, 3, 2, 4).reshape(n, gh * gw, -1)
    top, idx = jax.lax.top_k(score, k)                     # [N, B, k]
    # recover pixel coords from bucket-local flat index
    by = jnp.arange(gh * gw) // gw
    bx = jnp.arange(gh * gw) % gw
    ly = idx // gridsize
    lx = idx % gridsize
    y = by[None, :, None] * gridsize + ly
    x = bx[None, :, None] * gridsize + lx
    ok = jnp.isfinite(top)
    return (x.reshape(n, -1), y.reshape(n, -1), top.reshape(n, -1),
            ok.reshape(n, -1))


def detect_features(img: jnp.ndarray, mask: jnp.ndarray,
                    widths: jnp.ndarray, heights: jnp.ndarray,
                    fcsize: int = 16):
    """Full feature detection for a level-`level` image batch.

    img: [N, H, W, 3] float (0..255, the chosen pyramid level); mask:
    [N, H, W] combined mask&edge plane; widths/heights: [N] true dims.

    Returns dict of [N, F] arrays: x, y, response, type (0 harris,
    1 dog), valid. Matches CDetectFeatures::run with fcsize=16
    (findMatch.cpp:80-82): gridsize = fcsize*2, <=4 per bucket per
    detector, detection margins 8 (harris, sigma=4) and ceil(2*cscale)
    (dog).
    """
    n, h, w = img.shape[:3]
    gridsize = fcsize * 2
    xs = jnp.arange(w)[None, None, :]
    ys = jnp.arange(h)[None, :, None]
    inside = ((xs < widths[:, None, None]) & (ys < heights[:, None, None]))

    def margin_ok(m):
        return ((xs >= m) & (xs < widths[:, None, None] - m)
                & (ys >= m) & (ys < heights[:, None, None] - m))

    hr = harris_response(img, mask * inside)
    hx, hy, hrv, hok = bucket_topk(
        hr, (hr != 0.0) & margin_ok(8), gridsize)

    dr, cscales = dog_responses(img, mask * inside)
    # first-scale-wins dedup (dog.cpp alreadydetected): zero later scales
    # where an earlier scale already fired
    fired = jnp.zeros_like(dr[0], bool)
    per_scale = []
    for s in range(dr.shape[0]):
        m = int(math.ceil(2 * cscales[s]))
        cur = (dr[s] != 0.0) & ~fired & margin_ok(m)
        fired = fired | (dr[s] != 0.0)
        per_scale.append(jnp.where(cur, dr[s], 0.0))
    dmap = per_scale[0]
    for s in range(1, len(per_scale)):
        # distinct pixels by construction; sum merges the scale maps
        dmap = dmap + per_scale[s]
    dx, dy, drv, dok = bucket_topk(dmap, dmap != 0.0, gridsize)

    x = jnp.concatenate([hx, dx], axis=1)
    y = jnp.concatenate([hy, dy], axis=1)
    r = jnp.concatenate([hrv, drv], axis=1)
    t = jnp.concatenate([jnp.zeros_like(hx), jnp.ones_like(dx)], axis=1)
    ok = jnp.concatenate([hok, dok], axis=1)
    return {"x": x, "y": y, "response": r, "type": t, "valid": ok}
