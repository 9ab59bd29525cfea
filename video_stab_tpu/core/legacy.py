"""Legacy deterministic stabilizer — rebuild of
src/Stabilizer_legacy.cpp (the RANSAC-free "robust shake-avoiding" variant
that shares vs::Stabilizer's public API).

This is the exact-parity path (SURVEY.md §4): GFTT + pyramidal LK 21x21/3
levels + err<30 filter + median-motion outlier rejection + closed-form
centroid/atan2 rigid solve + shake damping + centered box smoothing. Every
stage is deterministic, so per-frame transform parity vs the reference
semantics can be tested bitwise-in-float32 on recorded clips.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from video_stab_tpu.core.params import LegacyStabilizerParams
from video_stab_tpu.core.state import LegacyState, legacy_state_init
from video_stab_tpu.motion.estimate import (
    estimate_rigid_closed_form,
    remove_outliers_median,
)
from video_stab_tpu.motion.filters import box_filter_emit, ring_get, ring_push
from video_stab_tpu.ops.color import bgr_to_gray, saturate_u8
from video_stab_tpu.ops.features import good_features_to_track
from video_stab_tpu.ops.lk import lk_track
from video_stab_tpu.ops.warp import (
    border_mode_from_name,
    similarity_matrix,
    warp_affine_fast,
)


def _detect_features(params: LegacyStabilizerParams, gray: jnp.ndarray):
    """detectInitialFeatures (Stabilizer_legacy.cpp:163-193): GFTT + border
    margin filter."""
    h, w = gray.shape
    pts, mask = good_features_to_track(
        gray, max_corners=params.max_corners,
        quality_level=params.quality_level,
        min_distance=params.min_distance,
        block_size=params.block_size)
    m = params.feature_border_margin
    inside = ((pts[:, 0] > m) & (pts[:, 1] > m) &
              (pts[:, 0] < w - m) & (pts[:, 1] < h - m))
    return pts, mask & inside


def _suppress_shake(params: LegacyStabilizerParams, t: jnp.ndarray) -> jnp.ndarray:
    """suppressShake (Stabilizer_legacy.cpp:360-378): damp x0.15 when both
    |translation| < 3 px and |rotation| < 0.03 rad."""
    t_mag = jnp.sqrt(t[0] ** 2 + t[1] ** 2)
    r_mag = jnp.abs(t[2])
    is_shake = (t_mag < params.shake_threshold_px) & \
               (r_mag < params.rotation_shake_rad)
    return jnp.where(is_shake, t * params.shake_damping_factor, t)


def legacy_init_step_fn(params: LegacyStabilizerParams, state: LegacyState,
                     frame_u8: jnp.ndarray) -> LegacyState:
    """initializeFirstFrame (Stabilizer_legacy.cpp:144-161).

    The first frame is NOT queued: the queue starts with the second input at
    index 0, aligned with transforms_[0] (legacy:119-123 with
    nextFrameIndex_ still 0 after init)."""
    gray = bgr_to_gray(frame_u8.astype(jnp.float32))
    pts, mask = _detect_features(params, gray)
    return state._replace(prev_gray=gray, prev_pts=pts, prev_mask=mask)


def legacy_analyze_step_fn(params: LegacyStabilizerParams, state: LegacyState,
                        frame_u8: jnp.ndarray) -> tuple[LegacyState, dict]:
    """generateTransform (Stabilizer_legacy.cpp:195-281)."""
    gray = bgr_to_gray(frame_u8.astype(jnp.float32))

    curr_pts, status, err = lk_track(
        state.prev_gray, gray, state.prev_pts, state.prev_mask,
        win=params.lk_window, max_level=params.lk_levels,
        iters=params.lk_iters, eps=params.lk_eps)
    good = state.prev_mask & status & (err < params.lk_err_threshold)
    n_good = jnp.sum(good.astype(jnp.int32))

    # Median outlier rejection + closed-form rigid + shake damping.
    kept = remove_outliers_median(
        state.prev_pts, curr_pts, good,
        threshold=params.outlier_threshold, min_keep=10)
    t = estimate_rigid_closed_form(state.prev_pts, curr_pts, kept)
    t = _suppress_shake(params, t)

    low_features = n_good < params.min_tracking_features
    raw = jnp.where(low_features, jnp.zeros(3, jnp.float32), t)

    n = state.n_path
    prev_path = jnp.where(n > 0, ring_get(state.path_ring, n - 1),
                          jnp.zeros(3, jnp.float32))
    new_path = jnp.where(n > 0, prev_path + raw, raw)
    trans_ring = ring_push(state.trans_ring, n, raw)
    path_ring = ring_push(state.path_ring, n, new_path)

    # Feature maintenance: re-detect on starvation or every 30th good frame
    # (legacy:236-248, 276-280); otherwise carry the tracked points forward
    # with their validity (the reference carries raw failed points too —
    # legacy:272 — which we drop via the mask instead).
    fsd = jnp.where(low_features, state.frames_since_detect,
                    state.frames_since_detect + 1)
    do_redetect = low_features | (fsd > params.redetect_interval)

    def redetect(_):
        return _detect_features(params, gray)

    def keep(_):
        return curr_pts, state.prev_mask & status

    prev_pts, prev_mask = jax.lax.cond(do_redetect, redetect, keep, None)
    fsd = jnp.where(do_redetect & ~low_features, jnp.int32(0), fsd)

    q = state.frame_ring.shape[0]
    new_state = state._replace(
        prev_gray=gray,
        prev_pts=prev_pts,
        prev_mask=prev_mask,
        trans_ring=trans_ring,
        path_ring=path_ring,
        n_path=n + 1,
        frame_ring=state.frame_ring.at[state.n_frames % q].set(frame_u8),
        n_frames=state.n_frames + 1,
        frames_since_detect=fsd,
    )
    metrics = {"n_tracked": n_good, "transform": raw,
               "redetected": do_redetect}
    return new_state, metrics


def legacy_emit_step_fn(params: LegacyStabilizerParams, state: LegacyState,
                     ) -> tuple[LegacyState, jnp.ndarray]:
    """applyNextSmoothTransform + applyTransform
    (Stabilizer_legacy.cpp:380-502)."""
    e = state.emit_idx
    has_transform = e < state.n_path
    e_safe = jnp.minimum(e, jnp.maximum(state.n_path - 1, 0))

    # Centered box smoothing over the cumulative path (legacy:412-434).
    r = params.box_radius
    smoothed = box_filter_emit(
        state.path_ring, state.n_path, e_safe,
        jnp.int32(r), r_max=max(r, 1))
    raw_path = ring_get(state.path_ring, e_safe)
    correction = jnp.where(has_transform, smoothed - raw_path,
                           jnp.zeros(3, jnp.float32))

    q = state.frame_ring.shape[0]
    frame = state.frame_ring[e % q].astype(jnp.float32)
    h, w = frame.shape[0], frame.shape[1]
    border_mode = border_mode_from_name(params.border_type)
    b = params.border_size

    if not params.crop_n_zoom:
        # Larger canvas + offset + crop back (legacy:465-494). The transform
        # translation is shifted by the padding; the output crop starts at
        # (b/2, b/2) and keeps the original size.
        m = similarity_matrix(correction[0] + b, correction[1] + b,
                              correction[2])
        canvas = warp_affine_fast(frame, m, out_h=h + 2 * b,
                                  out_w=w + 2 * b,
                                  border_mode=border_mode)
        cx = min(max(0, b // 2), 2 * b)
        cy = min(max(0, b // 2), 2 * b)
        out = canvas[cy:cy + h, cx:cx + w] if b > 0 else canvas
    else:
        m = similarity_matrix(correction[0], correction[1], correction[2])
        out = warp_affine_fast(frame, m, border_mode=border_mode)

    out_u8 = saturate_u8(out)
    return state._replace(emit_idx=e + 1), out_u8




# Jitted aliases (static params, donated state) — the streaming wrappers
# use these; `*_fn` are the raw pure functions for vmap/shard_map composition.
legacy_init_step = jax.jit(legacy_init_step_fn, static_argnums=0, donate_argnums=1)
legacy_analyze_step = jax.jit(legacy_analyze_step_fn, static_argnums=0, donate_argnums=1)
legacy_emit_step = jax.jit(legacy_emit_step_fn, static_argnums=0, donate_argnums=1)


class LegacyStabilizer:
    """Streaming wrapper over the legacy deterministic path. Unlike
    ``Stabilizer``, the first frame is returned as-is (legacy:160)."""

    def __init__(self, params: Optional[LegacyStabilizerParams] = None, **kw):
        if params is None:
            params = LegacyStabilizerParams(**kw)
        elif kw:
            raise ValueError("pass either params or keyword overrides")
        self.params = params
        self._state: Optional[LegacyState] = None
        self._shape: Optional[tuple] = None
        self._initialized = False
        self.last_metrics: dict = {}

    def _ensure_state(self, frame: np.ndarray) -> None:
        h, w = frame.shape[:2]
        if self._state is None:
            self._state = legacy_state_init(self.params, h, w)
            self._shape = (h, w)
        elif self._shape != (h, w):
            raise ValueError(
                f"frame size changed {self._shape} -> {(h, w)}; call clean()")

    @property
    def _queued(self) -> int:
        if self._state is None:
            return 0
        return int(self._state.n_frames) - int(self._state.emit_idx)

    def stabilize(self, frame) -> Optional[np.ndarray]:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.ndim == 2:
            frame = np.repeat(frame[:, :, None], 3, axis=2)
        self._ensure_state(frame)
        st = self._state
        if not self._initialized:
            self._state = legacy_init_step(self.params, st, frame)
            self._initialized = True
            return frame  # first frame passes through (legacy:160)
        self._state, metrics = legacy_analyze_step(self.params, st, frame)
        self.last_metrics = metrics
        if self._queued < self.params.effective_radius:
            return None
        self._state, out = legacy_emit_step(self.params, self._state)
        return np.asarray(out)

    def flush(self) -> Optional[np.ndarray]:
        if self._state is None or self._queued <= 0:
            return None
        self._state, out = legacy_emit_step(self.params, self._state)
        return np.asarray(out)

    def clean(self) -> None:
        self._state = None
        self._shape = None
        self._initialized = False
        self.last_metrics = {}
