"""Device-resident image/mask/edge pyramids for all views, as one mip atlas.

Batched replacement for the reference's per-image pyramid vectors
(reference include/image/image.hpp, source/image/image.cpp:228-405): all N
views live in one padded array per level, and all levels are packed
side-by-side along x into a single "atlas" array [N, H0, WA, 3] so that the
refinement kernel can gather at a *traced* per-(patch, view) level index
with ordinary dynamic indexing - no Python-level list indexing, no
lax.switch over levels.

Semantics matched to the reference:
  * level-l dims are w_{l-1}//2, h_{l-1}//2          (image.cpp:135-139)
  * color downsample: 4x4 binomial {1,3,3,1}x{1,3,3,1}/64 at stride 2,
    window centered at (2x, 2y) spanning offsets -1..2, taps clipped to
    [0, size-2] and the kernel renormalized at boundaries
    (image.cpp:228-325; note the reference *excludes* the last row/column)
  * per-level values are rounded to uint8 range       (image.cpp:317-320)
  * mask/edge downsample: 2x2 "any-in"                (image.cpp:330-405)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PyramidSet:
    """All pyramids of all views in packed mip-atlas form."""

    atlas: jax.Array       # [N, H0, WA, 3] f32, uint8-valued colors
    mask_atlas: jax.Array  # [N, H0, WA] f32: 1.0 = in mask, 0.0 = out
    edge_atlas: jax.Array  # [N, H0, WA] f32: 1.0 = textured/usable
    widths: jax.Array      # [L, N] i32 true per-view width at each level
    heights: jax.Array     # [L, N] i32
    xoff: jax.Array        # [L] i32 x offset of each level in the atlas
    num_levels: int = field(metadata=dict(static=True))

    @property
    def num_images(self) -> int:
        return self.atlas.shape[0]


def _binomial_downsample(img: jnp.ndarray, valid: jnp.ndarray,
                         quantize: bool = True
                         ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One pyramid step for a padded batch.

    img:   [N, H, W, C] float
    valid: [N, H, W] float - 1 where the tap may be used (in-image and not
           the reference-excluded last row/col)
    Returns ([N, H//2, W//2, C], conv denominator [N, H//2, W//2]).
    """
    n, h, w, c = img.shape
    oh, ow = h // 2, w // 2
    k1 = jnp.array([1.0, 3.0, 3.0, 1.0], img.dtype)
    k = jnp.outer(k1, k1) / 64.0

    # output (x) window = input 2x-1 .. 2x+2  => pad lo 1, hi enough
    pad_w = (1, max(0, 2 * ow + 2 - w - 1))
    pad_h = (1, max(0, 2 * oh + 2 - h - 1))

    def conv(x, feature_count):
        # x: [N, H, W, F] -> [N, oh, ow, F] depthwise 4x4 stride 2
        kernel = jnp.zeros((4, 4, 1, 1), img.dtype) + k[:, :, None, None]
        kernel = jnp.tile(kernel, (1, 1, 1, feature_count))
        return jax.lax.conv_general_dilated(
            x, kernel, window_strides=(2, 2),
            padding=(pad_h, pad_w),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=feature_count)

    num = conv(img * valid[..., None], c)[:, :oh, :ow]
    den = conv(valid[..., None], 1)[:, :oh, :ow, 0]
    safe = jnp.where(den > 0.0, den, 1.0)
    out = jnp.where(den[..., None] > 0.0, num / safe[..., None], 0.0)
    if quantize:
        out = jnp.floor(out + 0.5)
    return out, den


def _any_in_downsample(mask: jnp.ndarray) -> jnp.ndarray:
    """2x2 stride-2 max-pool (reference buildMask/buildEdge any-in)."""
    n, h, w = mask.shape
    oh, ow = h // 2, w // 2
    m = mask[:, :oh * 2, :ow * 2].reshape(n, oh, 2, ow, 2)
    return m.max(axis=(2, 4))


def _valid_tap_mask(widths: np.ndarray, heights: np.ndarray,
                    h: int, w: int) -> np.ndarray:
    """[N, h, w] 1.0 where x <= w_i-2 and y <= h_i-2 (conv tap validity;
    the reference skips taps at size-1, image.cpp:262-267)."""
    xs = np.arange(w)[None, None, :]
    ys = np.arange(h)[None, :, None]
    return ((xs <= widths[:, None, None] - 2)
            & (ys <= heights[:, None, None] - 2)).astype(np.float32)


def _inside_mask(widths: np.ndarray, heights: np.ndarray,
                 h: int, w: int) -> np.ndarray:
    xs = np.arange(w)[None, None, :]
    ys = np.arange(h)[None, :, None]
    return ((xs < widths[:, None, None])
            & (ys < heights[:, None, None])).astype(np.float32)


def build_pyramids(images: list[np.ndarray],
                   masks: list[np.ndarray] | None,
                   num_levels: int,
                   edges: list[np.ndarray] | None = None,
                   dtype=jnp.float32,
                   gamma: float | None = None) -> PyramidSet:
    """Build the packed PyramidSet from per-view uint8 RGB images.

    `masks`/`edges` are optional per-view [H, W] arrays (nonzero = in);
    views without a mask behave as all-in (reference getMask returns 1 when
    no mask was loaded, image.hpp:180-203).

    `gamma`: the reference's compile-time FURUKAWA_IMAGE_GAMMA variant
    (image.cpp:184-195 decodeGamma): pixels become (v/255)^gamma floats
    and pyramid levels are NOT re-quantized to the byte grid.
    """
    n = len(images)
    widths0 = np.array([im.shape[1] for im in images], dtype=np.int64)
    heights0 = np.array([im.shape[0] for im in images], dtype=np.int64)

    # per-level true dims
    widths = [widths0]
    heights = [heights0]
    for _ in range(1, num_levels):
        widths.append(widths[-1] // 2)
        heights.append(heights[-1] // 2)

    h0, w0 = int(heights0.max()), int(widths0.max())
    # pad level-0 batch
    img0 = np.zeros((n, h0, w0, 3), dtype=np.float32)
    msk0 = np.zeros((n, h0, w0), dtype=np.float32)
    edg0 = np.zeros((n, h0, w0), dtype=np.float32)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        if gamma is not None:
            img0[i, :h, :w] = (im.astype(np.float32) / 255.0) ** gamma
        else:
            img0[i, :h, :w] = im.astype(np.float32)
        if masks is not None and masks[i] is not None:
            msk0[i, :h, :w] = (masks[i] > 0).astype(np.float32)
        else:
            msk0[i, :h, :w] = 1.0
        if edges is not None and edges[i] is not None:
            edg0[i, :h, :w] = (edges[i] > 0).astype(np.float32)
        else:
            edg0[i, :h, :w] = 1.0

    level_imgs = [jnp.asarray(img0, dtype)]
    level_msks = [jnp.asarray(msk0, dtype)]
    level_edgs = [jnp.asarray(edg0, dtype)]
    ph, pw = h0, w0
    for lv in range(1, num_levels):
        valid = jnp.asarray(
            _valid_tap_mask(widths[lv - 1], heights[lv - 1], ph, pw), dtype)
        img, _ = _binomial_downsample(level_imgs[-1], valid,
                                      quantize=gamma is None)
        msk = _any_in_downsample(level_msks[-1])
        edg = _any_in_downsample(level_edgs[-1])
        ph, pw = ph // 2, pw // 2
        inside = jnp.asarray(_inside_mask(widths[lv], heights[lv], ph, pw),
                             dtype)
        level_imgs.append(img * inside[..., None])
        level_msks.append(msk * inside)
        level_edgs.append(edg * inside)

    # pack into the atlas: level l occupies columns
    # [xoff[l], xoff[l] + w0//2^l), rows [0, h0//2^l)
    xoff = np.zeros(num_levels, dtype=np.int64)
    for lv in range(1, num_levels):
        xoff[lv] = xoff[lv - 1] + max(1, w0 >> (lv - 1))
    wa = int(xoff[-1] + max(1, w0 >> (num_levels - 1)))

    atlas = jnp.zeros((n, h0, wa, 3), dtype)
    mask_atlas = jnp.zeros((n, h0, wa), dtype)
    edge_atlas = jnp.zeros((n, h0, wa), dtype)
    for lv in range(num_levels):
        hlv, wlv = level_imgs[lv].shape[1:3]
        xs = int(xoff[lv])
        atlas = atlas.at[:, :hlv, xs:xs + wlv].set(level_imgs[lv])
        mask_atlas = mask_atlas.at[:, :hlv, xs:xs + wlv].set(level_msks[lv])
        edge_atlas = edge_atlas.at[:, :hlv, xs:xs + wlv].set(level_edgs[lv])

    return PyramidSet(
        atlas=atlas, mask_atlas=mask_atlas, edge_atlas=edge_atlas,
        widths=jnp.asarray(np.stack(widths), jnp.int32),
        heights=jnp.asarray(np.stack(heights), jnp.int32),
        xoff=jnp.asarray(xoff, jnp.int32),
        num_levels=num_levels)


def set_edge(pyr: PyramidSet, images: list[np.ndarray],
             threshold: float) -> PyramidSet:
    """Texturedness masks from Gaussian-blurred squared central gradients
    (reference image.cpp:407-471): edge = blur_g(sum_c (dx^2+dy^2)) over
    a sigma=3 window, thresholded at thr^2 * (2m+1)^2 / 3.
    """
    from dataclasses import replace
    sigma = 3.0
    margin = int(np.floor(2 * sigma))
    xs = np.arange(-margin, margin + 1)
    g = np.exp(-xs * xs / (2.0 * sigma * sigma)).astype(np.float32)

    edge_maps = []
    for im in images:
        imf = im.astype(np.float32)
        grad = np.zeros(imf.shape[:2], dtype=np.float32)
        gx = np.zeros_like(imf)
        gy = np.zeros_like(imf)
        gx[1:-1, 1:-1] = imf[1:-1, 2:] - imf[1:-1, :-2]
        gy[1:-1, 1:-1] = imf[2:, 1:-1] - imf[:-2, 1:-1]
        grad[1:-1, 1:-1] = (gx * gx + gy * gy)[1:-1, 1:-1].sum(axis=-1)
        # separable Gaussian, clamp-to-edge (reference filterG)
        blurred = _sep_filter_clamp(grad, g)
        new_thr = threshold * threshold * (2 * margin + 1) ** 2 / 3.0
        edge_maps.append((blurred > new_thr).astype(np.uint8) * 255)

    rebuilt = build_pyramids(
        images, None, pyr.num_levels, edges=edge_maps)
    return replace(pyr, edge_atlas=rebuilt.edge_atlas)


def _sep_filter_clamp(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    m = len(kernel) // 2
    padded = np.pad(img, ((0, 0), (m, m)), mode="edge")
    out = np.zeros_like(img)
    for i, kv in enumerate(kernel):
        out += kv * padded[:, i:i + img.shape[1]]
    padded = np.pad(out, ((m, m), (0, 0)), mode="edge")
    out2 = np.zeros_like(img)
    for i, kv in enumerate(kernel):
        out2 += kv * padded[i:i + img.shape[0], :]
    return out2
