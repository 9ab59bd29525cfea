"""Roll correction — rebuild of vs::RollCorrection
(src/RollCorrection.cpp, include/video/RollCorrection.h:16-38).

Per frame: downscale -> gray -> Canny -> Hough lines -> filter line angles to
[min, max] degrees around horizontal -> average -> exponential smoothing with
per-frame change clamp and decay-to-zero drift -> rotate about the center
with replicate borders.

The reference hides the smoothed angle in function-local statics
(RollCorrection.cpp:12-14 — one stream per process only); here it is an
explicit ``RollState`` so N streams can run batched/vmapped.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from video_stab_tpu.core.params import RollCorrectionParams
from video_stab_tpu.ops.canny import canny_edges
from video_stab_tpu.ops.color import bgr_to_gray, saturate_u8
from video_stab_tpu.ops.hough import hough_lines
from video_stab_tpu.ops.resize import resize_bilinear
from video_stab_tpu.ops.warp import (
    BORDER_REPLICATE,
    rotation_matrix_2d,
    warp_affine_fast,
)


class RollState(NamedTuple):
    smoothed_angle: jnp.ndarray   # float32 degrees


def roll_state_init() -> RollState:
    return RollState(smoothed_angle=jnp.float32(0.0))


def estimate_roll_angle(params: RollCorrectionParams, state: RollState,
                        frame_f32: jnp.ndarray) -> RollState:
    """Angle estimation + smoothing (RollCorrection.cpp:32-136). Returns the
    updated state; the caller rotates by ``state.smoothed_angle``."""
    h, w = frame_f32.shape[:2]
    sh = max(int(h * params.scale_factor), 1)
    sw = max(int(w * params.scale_factor), 1)
    gray = resize_bilinear(bgr_to_gray(frame_f32), sh, sw)
    edges = canny_edges(gray, params.canny_threshold_low,
                        params.canny_threshold_high)
    # Only near-horizontal lines survive the angle filter below, so the
    # accumulator sweeps just that theta window (+margin) — exact and ~8x
    # cheaper than the full 180-bin sweep (see ops/hough.py theta_range).
    lines, _votes, mask = hough_lines(
        edges, rho=params.hough_rho,
        theta=math.radians(params.hough_theta_deg),
        threshold=params.hough_threshold,
        max_lines=params.max_lines,
        theta_range=(math.radians(90.0 + params.angle_filter_min),
                     math.radians(90.0 + params.angle_filter_max)),
        impl=params.hough_impl, max_edges=params.hough_max_edges)

    # theta -> degrees around horizontal (RollCorrection.cpp:113-119).
    angles = lines[:, 1] * (180.0 / math.pi) - 90.0
    keep = mask & (angles >= params.angle_filter_min) & \
        (angles <= params.angle_filter_max)
    count = jnp.sum(keep.astype(jnp.float32))
    detected = jnp.sum(jnp.where(keep, angles, 0.0)) / jnp.maximum(count, 1.0)

    prev = state.smoothed_angle
    new_angle = params.angle_smoothing_alpha * detected + \
        (1.0 - params.angle_smoothing_alpha) * prev
    diff = new_angle - prev
    clamp = params.max_angle_change
    if clamp > 0.0:
        diff = jnp.clip(diff, -clamp, clamp)
    smoothed = jnp.where(count > 0, prev + diff, prev * params.angle_decay)
    return RollState(smoothed_angle=smoothed.astype(jnp.float32))


@functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
def roll_correct_step(params: RollCorrectionParams, state: RollState,
                      frame_u8: jnp.ndarray) -> tuple[RollState, jnp.ndarray]:
    """Full per-frame roll correction: estimate + rotate
    (RollCorrection.cpp:16-155)."""
    frame = frame_u8.astype(jnp.float32)
    h, w = frame.shape[:2]
    state = estimate_roll_angle(params, state, frame)
    rot = rotation_matrix_2d(w / 2.0, h / 2.0, state.smoothed_angle)
    out = warp_affine_fast(frame, rot, border_mode=BORDER_REPLICATE)
    return state, saturate_u8(out)


class RollCorrection:
    """Streaming wrapper. ``auto_correct_roll(frame)`` mirrors the reference's
    static API (RollCorrection.h:48) with explicit per-instance state."""

    def __init__(self, params: Optional[RollCorrectionParams] = None, **kw):
        if params is None:
            params = RollCorrectionParams(**kw)
        elif kw:
            raise ValueError("pass either params or keyword overrides")
        self.params = params
        self._state = roll_state_init()

    @property
    def smoothed_angle(self) -> float:
        return float(self._state.smoothed_angle)

    def auto_correct_roll(self, frame) -> np.ndarray:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        self._state, out = roll_correct_step(self.params, self._state, frame)
        return np.asarray(out)

    def reset(self) -> None:
        self._state = roll_state_init()
