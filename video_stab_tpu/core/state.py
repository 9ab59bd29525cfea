"""Explicit state pytrees for the streaming stabilizer.

The reference mutates ~40 hidden C++ member fields per frame
(include/video/Stabilizer.h:310-429). Here all streaming state is ONE
explicit, donate-able pytree that stays resident in HBM, so the per-frame
step is a pure function `(params, state, frame) -> (state, ...)` that jit
compiles once and can be vmapped over a batch of independent streams.

Ring-buffer layout: the cumulative path / raw transform histories live in
fixed rings of ``PATH_RING`` samples; absolute index i maps to slot
``i % PATH_RING``. All consumers (smoothers, intent analysis, adaptive
radius) only ever look back a bounded window — see
video_stab_tpu/motion/filters.py for the equivalence argument with the
reference's full-path re-smoothing (src/Stabilizer.cpp:783-839).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from video_stab_tpu.motion.hf import HFState, hf_init

# Ring capacity for path/transform histories. Must cover look-ahead
# (effective radius <= 35, Stabilizer.cpp:383) + the largest smoothing
# window (box radius <= 50 in drone mode, Stabilizer.cpp:1144-1146) + slack.
PATH_RING = 128


class StabilizerState(NamedTuple):
    """Full streaming state of one stabilized stream."""

    # Analysis-resolution tracking state
    prev_gray: jnp.ndarray        # (Ha, Wa) f32 — previous analysis grayscale
    prev_pts: jnp.ndarray         # (N, 2) f32 — tracked feature slots
    prev_mask: jnp.ndarray        # (N,) bool — feature slot validity

    # Trajectory rings (absolute index i -> slot i % PATH_RING)
    trans_ring: jnp.ndarray       # (PATH_RING, 3) raw per-frame transforms
    path_ring: jnp.ndarray        # (PATH_RING, 3) cumulative path
    n_path: jnp.ndarray           # int32 — number of transforms pushed

    # Look-ahead frame queue (frame index i -> slot i % Q)
    frame_ring: jnp.ndarray       # (Q, H, W, 3) uint8
    n_frames: jnp.ndarray        # int32 — frames pushed (incl. first)
    emit_idx: jnp.ndarray         # int32 — next frame index to emit
    # Per-queued-frame auxiliary rotation (degrees, about the frame
    # center) composed into the emit warp — the fused-chain roll path
    # (core/chain.py): frames queue UNROTATED, analysis runs on rotated
    # analysis-scale grays, and the roll rotation merges with the
    # stabilizing correction into ONE resample at emit. All zeros (and
    # composition-exact identity) outside the fused chain.
    aux_roll_ring: jnp.ndarray    # (Q,) f32 degrees

    # Kalman smoother cursor (advanced once per emitted frame)
    kalman_x: jnp.ndarray         # (2, 3) f32 — [position, velocity] per axis
    kalman_p: jnp.ndarray         # (2, 2, 3) f32 — covariance per axis
    butter_state: jnp.ndarray     # (4, 3) f32 — butterworth cascade stages

    # Drone high-frequency chain state
    hf: HFState

    # Fade border history (dummy (1,1,3) when border_type != "fade")
    fade_history: jnp.ndarray     # (H+2b, W+2b, 3) f32
    fade_count: jnp.ndarray       # int32

    # Virtual canvas accumulator (dummy (1,1,3)/(1,1) when disabled).
    # Allocated at the LARGEST admissible scale (adaptive mode:
    # max_canvas_scale); the ACTIVE window is the canvas_scale fraction.
    canvas: jnp.ndarray           # (Hc, Wc, 3) f32
    canvas_weight: jnp.ndarray    # (Hc, Wc) f32
    # Active canvas scale, frozen at the first canvas use from recent
    # motion when adaptive_canvas_size is on (calculateOptimalCanvasSize,
    # Stabilizer.cpp:2077, 2281-2306). 0.0 = not yet decided.
    canvas_scale: jnp.ndarray     # f32 scalar

    # Conditional-CLAHE feature starvation counter (Stabilizer.h:422)
    starvation_counter: jnp.ndarray  # int32

    # Envelope-violation observability: count of emitted corrections that
    # a static warp envelope degraded. Every warp on the emit path (the
    # plain emit and the virtual canvas) is the u8 gather warp, which has
    # no envelope, so it stays 0 (kept for the metrics surface).
    envelope_exceeded: jnp.ndarray  # int32

    # Stream PRNG (RANSAC hypothesis sampling)
    key: jax.Array

    # DeepStab network weights when deep_stabilization is on (else empty
    # tuple — still a valid pytree leaf-set for vmap/donation)
    deepstab: object = ()


def motion_channels(params) -> int:
    """Trajectory channel count: 3 for the similarity model (dx, dy, da),
    9 for the homography model (flattened sl(3) log-homography)."""
    return 9 if getattr(params, "motion_model", "similarity") == \
        "homography" else 3


def stabilizer_state_init(params, height: int, width: int) -> StabilizerState:
    """Allocate the state pytree for a (height, width) BGR stream."""
    ha, wa = params.analysis_height, params.analysis_width
    n = params.max_corners
    q = params.effective_radius + 1
    b = params.border_pad
    c = motion_channels(params)
    if params.border_type == "fade" and b > 0 and not params.crop_n_zoom:
        fade_shape = (height + 2 * b, width + 2 * b, 3)
    else:
        fade_shape = (1, 1, 3)
    if params.enable_virtual_canvas:
        from video_stab_tpu.core.canvas import canvas_shape
        hc, wc = canvas_shape(params, height, width)
    else:
        hc, wc = 1, 1
    return StabilizerState(
        prev_gray=jnp.zeros((ha, wa), jnp.float32),
        prev_pts=jnp.zeros((n, 2), jnp.float32),
        prev_mask=jnp.zeros((n,), bool),
        trans_ring=jnp.zeros((PATH_RING, c), jnp.float32),
        path_ring=jnp.zeros((PATH_RING, c), jnp.float32),
        n_path=jnp.int32(0),
        frame_ring=jnp.zeros((q, height, width, 3), jnp.uint8),
        n_frames=jnp.int32(0),
        emit_idx=jnp.int32(0),
        aux_roll_ring=jnp.zeros((q,), jnp.float32),
        kalman_x=jnp.zeros((2, c), jnp.float32),
        kalman_p=jnp.zeros((2, 2, c), jnp.float32),
        butter_state=jnp.zeros((4, c), jnp.float32),
        hf=hf_init(),
        fade_history=jnp.zeros(fade_shape, jnp.float32),
        fade_count=jnp.int32(0),
        canvas=jnp.zeros((hc, wc, 3), jnp.float32),
        canvas_weight=jnp.zeros((hc, wc), jnp.float32),
        canvas_scale=jnp.float32(0.0),
        starvation_counter=jnp.int32(0),
        envelope_exceeded=jnp.int32(0),
        key=jax.random.PRNGKey(params.seed),
        deepstab=(),
    )


class LegacyState(NamedTuple):
    """Streaming state of the legacy deterministic path
    (src/Stabilizer_legacy.cpp)."""

    prev_gray: jnp.ndarray        # (H, W) f32 full-resolution grayscale
    prev_pts: jnp.ndarray         # (N, 2) f32
    prev_mask: jnp.ndarray        # (N,) bool
    trans_ring: jnp.ndarray       # (PATH_RING, 3)
    path_ring: jnp.ndarray        # (PATH_RING, 3)
    n_path: jnp.ndarray           # int32
    frame_ring: jnp.ndarray       # (Q, H, W, 3) uint8
    n_frames: jnp.ndarray         # int32
    emit_idx: jnp.ndarray         # int32
    frames_since_detect: jnp.ndarray  # int32 (legacy:276-280)


def legacy_state_init(params, height: int, width: int) -> LegacyState:
    n = params.max_corners
    q = params.effective_radius + 1
    return LegacyState(
        prev_gray=jnp.zeros((height, width), jnp.float32),
        prev_pts=jnp.zeros((n, 2), jnp.float32),
        prev_mask=jnp.zeros((n,), bool),
        trans_ring=jnp.zeros((PATH_RING, 3), jnp.float32),
        path_ring=jnp.zeros((PATH_RING, 3), jnp.float32),
        n_path=jnp.int32(0),
        frame_ring=jnp.zeros((q, height, width, 3), jnp.uint8),
        n_frames=jnp.int32(0),
        emit_idx=jnp.int32(0),
        frames_since_detect=jnp.int32(0),
    )
