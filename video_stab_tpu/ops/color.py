"""Color conversions with OpenCV value conventions (u8 domain, BGR order).

Counterpart of the reference's cv::cvtColor call sites
(reference: src/Stabilizer.cpp:437,450; src/Enhancer.cpp:44,62;
src/RollCorrection.cpp:51; src/AutoZoomCrop.cpp:116).

All functions take/return float32 arrays carrying u8-scaled values
([0,255]); callers saturate back to uint8 at the host boundary with
:func:`saturate_u8`. Channel order is BGR, matching the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 products at full f32 precision on every backend (DESIGN.md §2a).
_HIGHEST = jax.lax.Precision.HIGHEST

# OpenCV ITU-R BT.601 luma weights (B, G, R order).
_GRAY_W = (0.114, 0.587, 0.299)


def saturate_u8(x: jnp.ndarray) -> jnp.ndarray:
    """cv::saturate_cast<uchar>: round-half-away then clamp to [0,255], uint8.

    No-op passthrough for u8 input (jnp.clip's float bounds would
    otherwise promote the whole frame through f32 and back)."""
    if x.dtype == jnp.uint8:
        return x
    return jnp.clip(jnp.round(x), 0.0, 255.0).astype(jnp.uint8)


def bgr_to_gray(bgr: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W, 3) BGR -> (..., H, W) gray. BT.601 weights like cv::COLOR_BGR2GRAY."""
    w = jnp.asarray(_GRAY_W, dtype=bgr.dtype)
    return jnp.matmul(bgr, w, precision=_HIGHEST)


def gray_to_bgr(gray: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) -> (..., H, W, 3) by channel replication (cv::COLOR_GRAY2BGR)."""
    return jnp.broadcast_to(gray[..., None], gray.shape + (3,))


def bgr_to_hsv(bgr: jnp.ndarray) -> jnp.ndarray:
    """cv::COLOR_BGR2HSV for u8-domain values: H in [0,180), S,V in [0,255]."""
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    v = jnp.maximum(jnp.maximum(b, g), r)
    mn = jnp.minimum(jnp.minimum(b, g), r)
    diff = v - mn
    safe = jnp.where(diff > 0, diff, 1.0)
    s = jnp.where(v > 0, 255.0 * diff / jnp.where(v > 0, v, 1.0), 0.0)
    # Hue in degrees /2 (OpenCV u8 convention).
    h_r = (g - b) / safe
    h_g = 2.0 + (b - r) / safe
    h_b = 4.0 + (r - g) / safe
    h = jnp.where(v == r, h_r, jnp.where(v == g, h_g, h_b)) * 30.0
    h = jnp.where(diff > 0, h, 0.0)
    h = jnp.where(h < 0, h + 180.0, h)
    return jnp.stack([h, s, v], axis=-1)


def hsv_to_bgr(hsv: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`bgr_to_hsv` (u8-domain H in [0,180))."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h60 = h / 30.0  # sector in [0, 6)
    i = jnp.floor(h60)
    f = h60 - i
    sn = s / 255.0
    p = v * (1.0 - sn)
    q = v * (1.0 - sn * f)
    t = v * (1.0 - sn * (1.0 - f))
    i = i.astype(jnp.int32) % 6
    r = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [v, q, p, p, t, v])
    g = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [t, v, v, q, p, p])
    b = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [p, p, t, v, v, q])
    return jnp.stack([b, g, r], axis=-1)


# BT.601 limited-range ("studio swing") RGB -> YCbCr, the colorspace the
# host encoder consumes (AV_PIX_FMT_YUV420P; swscale's default matrix for
# SD content). Device-side conversion halves the device->host payload
# (12 bits/px I420 vs 24 bits/px BGR) and removes the per-frame host
# sws_scale pass the encoder otherwise runs (native/codec.cpp vs_enc_encode;
# reference: src/RTSPServer.cpp:79-92 — x264enc's native input is I420).
_Y_W = (25.064, 129.057, 65.738)      # B, G, R weights, /256, +16
_U_W = (112.439, -74.494, -37.945)    # B, G, R weights, /256, +128
_V_W = (-18.285, -94.154, 112.439)    # B, G, R weights, /256, +128


def bgr_to_i420(bgr_u8: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 3) u8 BGR -> (H*3/2, W) u8 planar I420 (BT.601 limited range).

    The output's flat bytes are exactly an I420 buffer: Y plane (H rows),
    then the (H/2, W/2) U plane packed two half-rows per output row, then V
    likewise — what ``VideoEncoder.encode_yuv`` / libx264 consume with no
    host-side colorspace pass. Requires H % 4 == 0 and W % 2 == 0 (every
    standard video size; pad otherwise).

    Chroma is 2x2 box-averaged from the per-pixel Cb/Cr (swscale's default
    center siting approximation). Rounding is round-half-away (the u8
    saturate convention used across ops/).
    """
    h, w = bgr_u8.shape[0], bgr_u8.shape[1]
    if h % 4 or w % 2:
        raise ValueError(f"I420 needs H%4==0 and W%2==0, got {h}x{w}")
    f = bgr_u8.astype(jnp.float32)

    def dot(wts):
        return jnp.matmul(f, jnp.asarray(wts, jnp.float32),
                          precision=_HIGHEST) * (1.0 / 256.0)

    y = dot(_Y_W) + 16.0
    u = dot(_U_W) + 128.0
    v = dot(_V_W) + 128.0
    # 2x2 chroma subsample (box average).
    u = u.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    v = v.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    def _u8(x):
        return jnp.clip(jnp.floor(x + 0.5), 0.0, 255.0).astype(jnp.uint8)

    return jnp.concatenate(
        [_u8(y), _u8(u).reshape(h // 4, w), _u8(v).reshape(h // 4, w)],
        axis=0)


def i420_to_bgr(i420_u8: jnp.ndarray, height: int) -> jnp.ndarray:
    """Inverse of :func:`bgr_to_i420` (nearest-neighbor chroma upsample).

    Used by tests and the preview path; the production decode path stays in
    the native decoder (libswscale)."""
    h = height
    w = i420_u8.shape[1]
    y = i420_u8[:h].astype(jnp.float32) - 16.0
    u = i420_u8[h:h + h // 4].reshape(h // 2, w // 2).astype(jnp.float32)
    v = i420_u8[h + h // 4:].reshape(h // 2, w // 2).astype(jnp.float32)
    u = jnp.repeat(jnp.repeat(u, 2, axis=0), 2, axis=1) - 128.0
    v = jnp.repeat(jnp.repeat(v, 2, axis=0), 2, axis=1) - 128.0
    # Inverse of the limited-range matrix above (255/219 luma, 255/224
    # chroma scale; Kr=0.299, Kb=0.114).
    yl = y * (255.0 / 219.0)
    r = yl + 1.596027 * v
    g = yl - 0.391762 * u - 0.812968 * v
    b = yl + 2.017232 * u
    return jnp.clip(jnp.stack([b, g, r], axis=-1), 0.0, 255.0)


def _srgb_to_linear(c: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c: jnp.ndarray) -> jnp.ndarray:
    c = jnp.maximum(c, 0.0)
    return jnp.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


# sRGB -> XYZ (D65), rows produce X, Y, Z from (R, G, B).
_RGB2XYZ = jnp.asarray(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]], dtype=jnp.float32)
_XYZ2RGB = jnp.asarray(
    [[3.240479, -1.537150, -0.498535],
     [-0.969256, 1.875992, 0.041556],
     [0.055648, -0.204043, 1.057311]], dtype=jnp.float32)
_WHITE = jnp.asarray([0.950456, 1.0, 1.088754], dtype=jnp.float32)


def _f_lab(t: jnp.ndarray) -> jnp.ndarray:
    d = 6.0 / 29.0
    return jnp.where(t > d ** 3, jnp.cbrt(t), t / (3 * d * d) + 4.0 / 29.0)


def _f_lab_inv(t: jnp.ndarray) -> jnp.ndarray:
    d = 6.0 / 29.0
    return jnp.where(t > d, t ** 3, 3 * d * d * (t - 4.0 / 29.0))


def bgr_to_lab(bgr: jnp.ndarray) -> jnp.ndarray:
    """cv::COLOR_BGR2Lab (u8 scaling: L*255/100, a/b offset by 128)."""
    rgb = bgr[..., ::-1] / 255.0
    lin = _srgb_to_linear(rgb)
    xyz = jnp.matmul(lin, _RGB2XYZ.T, precision=_HIGHEST)
    xyz = xyz / _WHITE
    fx, fy, fz = _f_lab(xyz[..., 0]), _f_lab(xyz[..., 1]), _f_lab(xyz[..., 2])
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return jnp.stack([L * 255.0 / 100.0, a + 128.0, b + 128.0], axis=-1)


def lab_to_bgr(lab: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`bgr_to_lab` (u8 scaling)."""
    L = lab[..., 0] * 100.0 / 255.0
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = jnp.stack([_f_lab_inv(fx), _f_lab_inv(fy), _f_lab_inv(fz)], axis=-1) * _WHITE
    lin = jnp.matmul(xyz, _XYZ2RGB.T, precision=_HIGHEST)
    rgb = _linear_to_srgb(lin)
    return jnp.clip(rgb[..., ::-1] * 255.0, 0.0, 255.0)
