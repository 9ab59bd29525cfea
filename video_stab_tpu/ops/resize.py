"""Bilinear resize and image pyramids, formulated as matmuls.

Counterpart of the reference's cv::resize / cv::cuda::resize call
sites (reference: src/Stabilizer.cpp:298,436,449; src/RollCorrection.cpp:41)
and cv::calcOpticalFlowPyrLK's internal pyramid (src/Stabilizer.cpp:611-619).

Bilinear resampling is a separable linear operator, so ``resize(img)`` is
``Wh @ img @ Ww`` with banded weight matrices built at trace time — the whole
resize is two dense products instead of per-pixel gathers.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

# f32 products at full f32 precision on every backend (DESIGN.md §2a).
_HIGHEST = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=128)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, OpenCV half-pixel centers."""
    scale = n_in / n_out
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x)
    frac = x - x0
    i0 = np.clip(x0.astype(np.int64), 0, n_in - 1)
    i1 = np.clip(x0.astype(np.int64) + 1, 0, n_in - 1)
    w = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    # Accumulate (i0 may equal i1 at the clamped edges).
    np.add.at(w, (rows, i0), (1.0 - frac).astype(np.float32))
    np.add.at(w, (rows, i1), frac.astype(np.float32))
    return w


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bilinear resize of (..., H, W) or (..., H, W, C) to (out_h, out_w).

    Matches cv2.resize(..., interpolation=cv2.INTER_LINEAR) float semantics.
    """
    has_channels = img.ndim >= 3 and img.shape[-1] in (1, 2, 3, 4)
    if has_channels:
        h, w = img.shape[-3], img.shape[-2]
    else:
        h, w = img.shape[-2], img.shape[-1]
    if (h, w) == (out_h, out_w):
        return img
    wh = jnp.asarray(_resize_weights(h, out_h))
    ww = jnp.asarray(_resize_weights(w, out_w))
    dtype = img.dtype if img.dtype in (jnp.float32, jnp.bfloat16) else jnp.float32
    x = img.astype(dtype)
    if has_channels:
        # (..., H, W, C): contract H then W.
        x = jnp.einsum("oh,...hwc->...owc", wh, x, precision=_HIGHEST)
        x = jnp.einsum("pw,...hwc->...hpc", ww, x, precision=_HIGHEST)
        return x
    x = jnp.einsum("oh,...hw->...ow", wh, x, precision=_HIGHEST)
    x = jnp.einsum("pw,...hw->...hp", ww, x, precision=_HIGHEST)
    return x


def resample_axis_aligned(img: jnp.ndarray, y0, sy, x0, sx,
                          out_h: int, out_w: int) -> jnp.ndarray:
    """Bilinear sampling of (H, W[, C]) at the axis-aligned map
    ``src = (x0 + x * sx, y0 + y * sy)`` with TRACED (dynamic) offsets and
    scales — ``warp_affine`` restricted to diagonal maps, as two on-device
    interpolation-matrix matmuls instead of a 2-D gather.

    Exact: for an axis-aligned map bilinear separates, out[o,p] =
    sum_ij wy[o,i] * wx[p,j] * img[i,j] with tent weights — the dense
    matmul adds only exact zeros. Out-of-range samples get partial/zero
    weight sums, matching warp_affine's BORDER_CONSTANT value 0.

    Serves AutoZoomCrop's dynamic crop+resize (the interior rect is
    data-dependent; AutoZoomCrop.cpp:246-270 does GPU warpAffine).
    """
    has_c = img.ndim == 3
    h, w = img.shape[:2]
    sy_o = y0 + jnp.arange(out_h, dtype=jnp.float32) * sy     # (out_h,)
    sx_o = x0 + jnp.arange(out_w, dtype=jnp.float32) * sx     # (out_w,)
    iy = jnp.arange(h, dtype=jnp.float32)
    ix = jnp.arange(w, dtype=jnp.float32)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(sy_o[:, None] - iy[None, :]))
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(sx_o[:, None] - ix[None, :]))
    x = img.astype(jnp.float32)
    if has_c:
        x = jnp.einsum("oh,hwc->owc", wy, x, precision=_HIGHEST)
        return jnp.einsum("pw,owc->opc", wx, x, precision=_HIGHEST)
    x = jnp.einsum("oh,hw->ow", wy, x, precision=_HIGHEST)
    return jnp.einsum("pw,ow->op", wx, x, precision=_HIGHEST)


# cv::pyrDown 5-tap kernel (1 4 6 4 1)/16.
_PYR_K = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


@functools.lru_cache(maxsize=128)
def _pyr_down_weights(n_in: int) -> np.ndarray:
    """(ceil(n/2), n_in) operator: 5-tap Gaussian (reflect-101 border) + decimate."""
    n_out = (n_in + 1) // 2
    w = np.zeros((n_out, n_in), dtype=np.float32)
    for o in range(n_out):
        c = 2 * o
        for t in range(-2, 3):
            i = c + t
            # BORDER_REFLECT_101: -1 -> 1, n -> n-2.
            if i < 0:
                i = -i
            if i >= n_in:
                i = 2 * (n_in - 1) - i
            w[o, i] += _PYR_K[t + 2]
    return w


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """cv::pyrDown: 5x5 Gaussian blur + 2x decimation of (..., H, W)."""
    h, w = img.shape[-2], img.shape[-1]
    wh = jnp.asarray(_pyr_down_weights(h))
    ww = jnp.asarray(_pyr_down_weights(w))
    x = jnp.einsum("oh,...hw->...ow", wh, img, precision=_HIGHEST)
    return jnp.einsum("pw,...hw->...hp", ww, x, precision=_HIGHEST)


def build_pyramid(img: jnp.ndarray, levels: int) -> list[jnp.ndarray]:
    """[img, pyrDown(img), ...] with ``levels + 1`` entries (OpenCV maxLevel)."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr
