"""Separable filtering, morphology, CLAHE and enhancement primitives.

Counterparts of the reference's filtering call sites:
cv::GaussianBlur / cuda::createGaussianFilter (src/Enhancer.cpp:124,161),
cv::createCLAHE (src/Enhancer.cpp:65, src/Stabilizer.cpp:2576),
cuda morphology (src/AutoZoomCrop.cpp:125-139), cv::threshold
(src/AutoZoomCrop.cpp:122,134), Sobel/Scharr derivatives inside
goodFeaturesToTrack and calcOpticalFlowPyrLK.

1-D convolutions along H/W are expressed as banded matmuls built at
trace time; morphology is shift-and-max over static structuring offsets.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

# f32 products at full f32 precision on every backend (DESIGN.md §2a).
_HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Separable convolution as banded matmuls (reflect-101 border like OpenCV).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _conv_matrix(n: int, kernel: tuple[float, ...]) -> np.ndarray:
    """(n, n) operator applying a centered 1-D kernel with reflect-101 border."""
    k = len(kernel)
    c = k // 2
    w = np.zeros((n, n), dtype=np.float32)
    for o in range(n):
        for t in range(k):
            i = o + t - c
            if n > 1:
                period = 2 * (n - 1)
                i = i % period
                if i >= n:
                    i = period - i
            else:
                i = 0
            w[o, i] += kernel[t]
    return w


def sep_filter2d(img: jnp.ndarray, kh: tuple[float, ...], kw: tuple[float, ...]) -> jnp.ndarray:
    """Separable filter over the last two spatial dims of (..., H, W[, C])."""
    has_c = img.ndim >= 3 and img.shape[-1] in (1, 2, 3, 4)
    if has_c:
        h, w = img.shape[-3], img.shape[-2]
        mh = jnp.asarray(_conv_matrix(h, tuple(kh)))
        mw = jnp.asarray(_conv_matrix(w, tuple(kw)))
        x = jnp.einsum("oh,...hwc->...owc", mh, img, precision=_HIGHEST)
        return jnp.einsum("pw,...hwc->...hpc", mw, x, precision=_HIGHEST)
    h, w = img.shape[-2], img.shape[-1]
    mh = jnp.asarray(_conv_matrix(h, tuple(kh)))
    mw = jnp.asarray(_conv_matrix(w, tuple(kw)))
    x = jnp.einsum("oh,...hw->...ow", mh, img, precision=_HIGHEST)
    return jnp.einsum("pw,...hw->...hp", mw, x, precision=_HIGHEST)


def gaussian_kernel_1d(sigma: float, ksize: int | None = None) -> tuple[float, ...]:
    """cv::getGaussianKernel; auto ksize like GaussianBlur(Size(0,0), sigma)
    on float input: ksize = round(sigma*4*2 + 1) | 1 (smooth.cpp)."""
    if ksize is None or ksize <= 0:
        ksize = int(round(sigma * 4.0 * 2.0 + 1.0))
    if ksize % 2 == 0:
        ksize += 1
    c = ksize // 2
    xs = np.arange(ksize, dtype=np.float64) - c
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k /= k.sum()
    return tuple(float(v) for v in k)


def gaussian_blur(img: jnp.ndarray, sigma: float, ksize: int | None = None) -> jnp.ndarray:
    k = gaussian_kernel_1d(sigma, ksize)
    return sep_filter2d(img, k, k)


def box_blur(img: jnp.ndarray, ksize: int) -> jnp.ndarray:
    k = tuple([1.0 / ksize] * ksize)
    return sep_filter2d(img, k, k)


def sobel(img: jnp.ndarray, aperture: int = 3) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sobel dx, dy with the given aperture (3 only), reflect-101 border.

    Returns raw OpenCV-scaled responses (smooth [1,2,1], diff [-1,0,1])."""
    if aperture != 3:
        raise ValueError("only aperture 3 supported")
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    gx = sep_filter2d(img, smooth, diff)
    gy = sep_filter2d(img, diff, smooth)
    return gx, gy


def scharr_derivs(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unit-gradient Scharr derivatives ([3,10,3]/16 smooth, [-1,0,1]/2 diff),
    the derivative filter used inside pyramidal LK (cv::detail::calcSharrDeriv
    up to its fixed-point 1/32 scale)."""
    smooth = (3.0 / 16, 10.0 / 16, 3.0 / 16)
    diff = (-0.5, 0.0, 0.5)
    gx = sep_filter2d(img, smooth, diff)
    gy = sep_filter2d(img, diff, smooth)
    return gx, gy


# ---------------------------------------------------------------------------
# Morphology (shift-and-max over static structuring-element offsets).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _ellipse_offsets(ksize: int) -> tuple[tuple[int, int], ...]:
    """Offsets of cv::getStructuringElement(MORPH_ELLIPSE, (k, k))."""
    r = ksize // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    offs = []
    for dy in range(-r, r + 1):
        # OpenCV's integer ellipse rasterization.
        dx_max = 0 if r == 0 else int(round(r * math.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
        if abs(dy) == r:
            dx_max = 0
        for dx in range(-dx_max, dx_max + 1):
            offs.append((dy, dx))
    return tuple(offs)


def _shift2d(img: jnp.ndarray, dy: int, dx: int, fill: float) -> jnp.ndarray:
    out = jnp.roll(img, (-dy, -dx), axis=(0, 1))
    h, w = img.shape[:2]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    valid = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
    return jnp.where(valid, out, fill)


def dilate(img: jnp.ndarray, ksize: int = 5) -> jnp.ndarray:
    """Grayscale dilation with an elliptical kernel (AutoZoomCrop.cpp:125)."""
    out = img
    for dy, dx in _ellipse_offsets(ksize):
        if (dy, dx) == (0, 0):
            continue
        out = jnp.maximum(out, _shift2d(img, dy, dx, -jnp.inf))
    return out


def erode(img: jnp.ndarray, ksize: int = 5) -> jnp.ndarray:
    out = img
    for dy, dx in _ellipse_offsets(ksize):
        if (dy, dx) == (0, 0):
            continue
        out = jnp.minimum(out, _shift2d(img, dy, dx, jnp.inf))
    return out


def morph_close(img: jnp.ndarray, ksize: int = 5) -> jnp.ndarray:
    """MORPH_CLOSE = dilate then erode (AutoZoomCrop.cpp:127-139)."""
    return erode(dilate(img, ksize), ksize)


def threshold_binary(img: jnp.ndarray, thresh: float, maxval: float = 255.0,
                     inverse: bool = False) -> jnp.ndarray:
    """cv::threshold THRESH_BINARY / THRESH_BINARY_INV."""
    mask = img > thresh
    if inverse:
        mask = ~mask
    return jnp.where(mask, maxval, 0.0).astype(img.dtype)


# ---------------------------------------------------------------------------
# CLAHE (contrast-limited adaptive histogram equalization).
# ---------------------------------------------------------------------------

def clahe(img: jnp.ndarray, clip_limit: float = 2.0, tile_grid: int = 8) -> jnp.ndarray:
    """cv::CLAHE on a single-channel u8-domain image (Enhancer.cpp:65,
    Stabilizer.cpp:2576). Per-tile clipped histogram -> LUT, bilinear LUT blend.

    The image is logically padded (replicate) so H, W divide the tile grid,
    matching cv::CLAHE::apply's internal copyMakeBorder.
    """
    h, w = img.shape
    ty = tx = tile_grid
    th = -(-h // ty)
    tw = -(-w // tx)
    ph, pw = th * ty, tw * tx
    x = img
    if (ph, pw) != (h, w):
        x = jnp.pad(x, ((0, ph - h), (0, pw - w)), mode="reflect")
    vals = jnp.clip(x, 0.0, 255.0).astype(jnp.int32)
    tile_row = jnp.arange(ph) // th
    tile_col = jnp.arange(pw) // tw
    tile_id = tile_row[:, None] * tx + tile_col[None, :]
    flat_bin = (tile_id * 256 + vals).reshape(-1)
    hist = jnp.zeros((ty * tx * 256,), jnp.float32).at[flat_bin].add(1.0)
    hist = hist.reshape(ty * tx, 256)

    # Integer clip + redistribution exactly as cv::CLAHE calcLut:
    # clipLimit = max(int(clip_limit*area/256), 1); excess spread as
    # batch = clipped//256 to all bins, the residual to bins 0, s, 2s, ...
    # with s = max(256//residual, 1).
    tile_area = th * tw
    clip = max(int(clip_limit * tile_area / 256.0), 1)
    clipped = jnp.sum(jnp.maximum(hist - clip, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, clip)
    batch = jnp.floor(clipped / 256.0)
    residual = clipped - batch * 256.0
    step = jnp.maximum(jnp.floor(256.0 / jnp.maximum(residual, 1.0)), 1.0)
    bins = jnp.arange(256, dtype=jnp.float32)[None, :]
    res_inc = ((jnp.mod(bins, step) == 0) &
               (jnp.floor(bins / step) < residual)).astype(jnp.float32)
    hist = hist + batch + res_inc
    cdf = jnp.cumsum(hist, axis=1)
    lut_scale = 255.0 / tile_area
    luts = jnp.clip(jnp.round(cdf * lut_scale), 0.0, 255.0)  # (T, 256)
    luts = luts.reshape(ty, tx, 256)

    # Bilinear interpolation between the 4 surrounding tile LUTs
    # (cv clahe.cpp: txf = x/tw - 0.5, weights before index clamping).
    ys = jnp.arange(ph, dtype=jnp.float32) / th - 0.5
    xs = jnp.arange(pw, dtype=jnp.float32) / tw - 0.5
    y0f = jnp.floor(ys)
    x0f = jnp.floor(xs)
    fy = ys - y0f
    fx = xs - x0f
    y0 = jnp.clip(y0f, 0, ty - 1).astype(jnp.int32)
    x0 = jnp.clip(x0f, 0, tx - 1).astype(jnp.int32)
    y1 = jnp.clip(y0f + 1, 0, ty - 1).astype(jnp.int32)
    x1 = jnp.clip(x0f + 1, 0, tx - 1).astype(jnp.int32)

    y0g = jnp.broadcast_to(y0[:, None], (ph, pw))
    y1g = jnp.broadcast_to(y1[:, None], (ph, pw))
    x0g = jnp.broadcast_to(x0[None, :], (ph, pw))
    x1g = jnp.broadcast_to(x1[None, :], (ph, pw))
    v00 = luts[y0g, x0g, vals]
    v01 = luts[y0g, x1g, vals]
    v10 = luts[y1g, x0g, vals]
    v11 = luts[y1g, x1g, vals]
    fyg = jnp.broadcast_to(fy[:, None], (ph, pw))
    fxg = jnp.broadcast_to(fx[None, :], (ph, pw))
    out = (v00 * (1 - fxg) + v01 * fxg) * (1 - fyg) + (v10 * (1 - fxg) + v11 * fxg) * fyg
    return out[:h, :w].astype(img.dtype)


# ---------------------------------------------------------------------------
# Enhancement helpers.
# ---------------------------------------------------------------------------

def unsharp_mask(img: jnp.ndarray, sharpness: float, blur_sigma: float) -> jnp.ndarray:
    """addWeighted(img, 1+s, gaussian(img, sigma), -s, 0) (Enhancer.cpp:121-127)."""
    blurred = gaussian_blur(img, blur_sigma)
    return img * (1.0 + sharpness) - blurred * sharpness


def bilateral_denoise(img: jnp.ndarray, strength: float, radius: int = 3,
                      sigma_space: float = 2.0) -> jnp.ndarray:
    """Edge-preserving denoise, the static-shape stand-in for
    cv::fastNlMeansDenoisingColored (Enhancer.cpp:130-135): a bilateral
    filter implemented as static shift-and-accumulate (pure VPU work, no
    data-dependent shapes). NLM's h parameter tracks the noise sigma; a
    bilateral needs its range sigma ~2.5x the noise sigma for comparable
    smoothing, hence the mapping below."""
    if strength <= 0:
        return img
    sigma_color = 2.5 * strength
    h2 = 2.0 * sigma_color * sigma_color
    s2 = 2.0 * sigma_space * sigma_space
    acc = jnp.zeros_like(img)
    wacc = jnp.zeros(img.shape[:2], img.dtype)
    center = img
    ref = img if img.ndim == 2 else jnp.mean(img, axis=-1)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = jnp.roll(img, (-dy, -dx), axis=(0, 1))
            ref_s = jnp.roll(ref, (-dy, -dx), axis=(0, 1))
            diff = ref_s - ref
            w = jnp.exp(-(diff * diff) / h2 - (dy * dy + dx * dx) / s2)
            acc = acc + (shifted * (w[..., None] if img.ndim == 3 else w))
            wacc = wacc + w
    wacc = jnp.where(wacc > 0, wacc, 1.0)
    return acc / (wacc[..., None] if img.ndim == 3 else wacc)
