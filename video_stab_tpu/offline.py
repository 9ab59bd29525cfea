"""Offline (batch) stabilization — the throughput mode.

The reference is stream-only: one frame in, one frame out, per-frame CUDA
calls. When the whole clip is available (file workflows, re-encode farms),
the device prefers batch shapes: motion analysis runs as a `lax.scan` over
the time axis (the only true sequential dependency), trajectory smoothing is
one whole-path filter, and warping is vmapped over frame chunks so each
dispatch carries a large regular batch.

API: ``stabilize_clip(frames, params)`` — frames (T, H, W, 3) uint8 in,
stabilized (T, H', W', 3) uint8 out, same border/crop semantics as the
streaming Stabilizer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from video_stab_tpu.core.params import StabilizerParams
from video_stab_tpu.core.stabilizer import _analysis_gray
from video_stab_tpu.motion.estimate import estimate_similarity_ransac
from video_stab_tpu.motion.filters import gaussian_kernel
from video_stab_tpu.ops.color import saturate_u8
from video_stab_tpu.ops.features import good_features_to_track
from video_stab_tpu.ops.lk import lk_track
from video_stab_tpu.ops.resize import resize_bilinear
from video_stab_tpu.ops.warp import (
    BORDER_CONSTANT,
    similarity_matrix,
    warp_affine_fast,
)

WARP_CHUNK = 8      # frames warped per vmapped dispatch


def _scan_motion(params: StabilizerParams, frames_u8: jnp.ndarray,
                 key: jax.Array, estimate) -> jnp.ndarray:
    """Shared motion-analysis scan over the clip: analysis gray + GFTT init
    + per-step LK track / redetect cadence, with ``estimate(pts, curr_pts,
    valid, sub)`` supplying the per-step motion output (similarity (3,) or
    log-homography (3, 3)) — ONE copy of the scan skeleton so a fix to the
    tracking/redetect logic can't silently miss a motion model."""
    grays = jax.vmap(lambda f: _analysis_gray(params, f.astype(jnp.float32))
                     )(frames_u8)
    pts0, mask0 = good_features_to_track(
        grays[0], max_corners=params.max_corners,
        quality_level=params.quality_level,
        min_distance=params.min_distance, block_size=params.block_size)

    def step(carry, gray):
        prev_gray, pts, mask, key, i = carry
        curr_pts, status, _ = lk_track(
            prev_gray, gray, pts, mask, win=params.lk_window,
            max_level=params.lk_levels, iters=params.lk_iters)
        valid = mask & status
        key, sub = jax.random.split(key)
        out = estimate(pts, curr_pts, valid, sub)

        def redetect(_):
            return good_features_to_track(
                gray, max_corners=params.max_corners, quality_level=0.02,
                min_distance=15.0, block_size=3)

        def keep(_):
            return curr_pts, valid

        pts, mask = jax.lax.cond(
            (i % params.redetect_interval) == 0, redetect, keep, None)
        return (gray, pts, mask, key, i + 1), out

    (_, _, _, _, _), outs = jax.lax.scan(
        step, (grays[0], pts0, mask0, key, jnp.int32(1)), grays[1:])
    return outs


@functools.partial(jax.jit, static_argnums=0)
def _analyze_clip(params: StabilizerParams, frames_u8: jnp.ndarray,
                  key: jax.Array) -> jnp.ndarray:
    """(T, H, W, 3) -> (T, 3) raw transforms, LAST entry zero (forward-
    motion convention — see the tail comment)."""

    def estimate(pts, curr_pts, valid, sub):
        m, _ok, _inl = estimate_similarity_ransac(
            pts, curr_pts, valid, sub, threshold=params.ransac_threshold,
            n_hypotheses=params.ransac_hypotheses)
        return jnp.stack([m[0, 2], m[1, 2],
                          jnp.arctan2(m[1, 0], m[0, 0])])

    raws = _scan_motion(params, frames_u8, key, estimate)
    # Forward-motion convention: transform[e] = motion e -> e+1, matching the
    # streaming stabilizer where frame e's transform is pushed while frame
    # e+1 is analyzed (Stabilizer.cpp:376-380 + emission at 850). The LAST
    # frame has no forward motion (zero, like flush past the queue end).
    # The vidgear correction formula raw + (smoothed - path) is only
    # stabilizing under THIS alignment: warped position of frame e becomes
    # x_e + raw[e] + sm[e] - path[e] = sm[e] + x_0.
    return jnp.concatenate([raws, jnp.zeros((1, 3), jnp.float32)], axis=0)


def _smooth_path(params: StabilizerParams, path: jnp.ndarray) -> jnp.ndarray:
    """Whole-path smoothing per smoothing_method. Box is the centered
    clamped-window mean the streaming stabilizer smooths with."""
    if params.smoothing_method == "gaussian":
        k = gaussian_kernel(params.gaussian_sigma)
        c = k.shape[0] // 2
        n = path.shape[0]
        idx = jnp.arange(n)[:, None] + (jnp.arange(k.shape[0]) - c)[None, :]
        idx = jnp.where(idx < 0, -idx, idx)
        idx = jnp.where(idx > n - 1, 2 * n - 1 - idx, idx)
        return jnp.einsum("k,nkc->nc", k, path[jnp.clip(idx, 0, n - 1)],
                          precision=jax.lax.Precision.HIGHEST)
    if params.smoothing_method == "l1":
        # Cinematic L1-optimal path (motion/l1path.py; no reference
        # counterpart — the crop box bound comes from border_size, falling
        # back to a 2% frame diagonal heuristic when borderless).
        from video_stab_tpu.motion.l1path import l1_smooth_path
        b = float(params.border_size) if params.border_size > 0 else 20.0
        bound = jnp.asarray([b, b, 0.05], jnp.float32)
        return l1_smooth_path(path, bound)
    if params.smoothing_method == "butterworth":
        # Whole-path causal IIR cascade — the same 4-stage first-order
        # chain the streaming path advances per emission
        # (core/stabilizer.py; reference butterworthFilter,
        # Stabilizer.cpp:2014-2041), scanned over the batch path.
        from video_stab_tpu.motion.filters import (butterworth_cascade,
                                                   jitter_frequency_cutoff)
        cutoff = jitter_frequency_cutoff(params.jitter_frequency)

        def bstep(carry, z):
            st, out = butterworth_cascade(carry, z, cutoff, 4)
            return st, out

        st0 = jnp.broadcast_to(path[0], (4, 3))
        _, out = jax.lax.scan(bstep, st0, path[1:])
        return jnp.concatenate([path[:1], out], axis=0)
    if params.smoothing_method == "kalman":
        def step(carry, z):
            x, p = carry
            from video_stab_tpu.motion.filters import kalman_step
            st, out = kalman_step({"x": x, "p": p}, z)
            return (st["x"], st["p"]), out
        x0 = jnp.stack([path[0], jnp.zeros(3)])
        (_, _), out = jax.lax.scan(step, (x0, jnp.zeros((2, 2, 3))), path[1:])
        return jnp.concatenate([path[:1], out], axis=0)
    return box_filter_centered(path, max(2, min(params.smoothing_radius, 50)))


def box_filter_centered(path: jnp.ndarray, r: int) -> jnp.ndarray:
    """Centered count-normalized box filter over a (T, C) path: the window
    [i-r, i+r] clamped to the path, divided by the true count
    (boxFilterConvolve, src/Stabilizer.cpp:1156-1168). Identity when
    T <= r (Stabilizer.cpp:1148-1150)."""
    n = path.shape[0]
    idx = jnp.arange(n)[:, None] + jnp.arange(-r, r + 1)[None, :]
    valid = (idx >= 0) & (idx <= n - 1)
    vals = path[jnp.clip(idx, 0, n - 1)]
    w = valid.astype(path.dtype)[:, :, None]
    sm = jnp.sum(vals * w, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1.0)
    return jnp.where(n <= r, path, sm)


def box_filter_convolve_reference(path: jnp.ndarray, r: int) -> jnp.ndarray:
    """The reference's one raw CUDA kernel, boxFilterConvolveCUDA
    (src/stabilizer_cuda.cu:7-67), in plain jnp over a (N,) or (N, C)
    path: median-pad with r samples of the (upper) median on each side,
    then out[i] = mean(padded[i .. i+r-1]), the mean of the r samples
    ENDING at i-1. Its interior equals ``box_filter_centered`` with
    window 2r'+1 = r, shifted by r'+1 (tests/test_offline.py)."""
    if r <= 0:
        return path
    squeeze = path.ndim == 1
    p2 = path[:, None] if squeeze else path
    n, c = p2.shape
    outs = []
    for ch in range(c):
        x = p2[:, ch]
        med = jnp.sort(x)[n // 2]       # std::nth_element upper median
        padded = jnp.concatenate([jnp.full((r,), med, x.dtype), x,
                                  jnp.full((r,), med, x.dtype)])
        csum = jnp.cumsum(jnp.concatenate([jnp.zeros((1,), x.dtype), padded]))
        idx = jnp.arange(n)
        outs.append((csum[idx + r] - csum[idx]) / float(r))
    res = jnp.stack(outs, axis=1)
    return res[:, 0] if squeeze else res


@functools.partial(jax.jit, static_argnums=0)
def _analyze_clip_homography(params: StabilizerParams,
                             frames_u8: jnp.ndarray,
                             key: jax.Array) -> jnp.ndarray:
    """(T, H, W, 3) -> (T, 3, 3) forward log-homographies (last = 0).

    Same scan as the similarity path, but the frame-to-frame motion is an
    8-DOF homography mapped into sl(3) (motion/homography.py; the
    log-homography model of arxiv 2011.08144). Coordinates are scaled from
    analysis to full resolution inside the conjugation S H S^-1."""
    from video_stab_tpu.motion.homography import (
        conjugate,
        estimate_homography_ransac,
        log_homography,
    )

    sx = frames_u8.shape[2] / params.analysis_width
    sy = frames_u8.shape[1] / params.analysis_height
    s_mat = jnp.diag(jnp.asarray([sx, sy, 1.0], jnp.float32))
    s_inv = jnp.diag(jnp.asarray([1.0 / sx, 1.0 / sy, 1.0], jnp.float32))

    def estimate(pts, curr_pts, valid, sub):
        h_mat, _ok, _inl = estimate_homography_ransac(
            pts, curr_pts, valid, sub, threshold=params.ransac_threshold,
            n_hypotheses=params.ransac_hypotheses)
        return log_homography(conjugate(s_mat, h_mat, s_inv))

    logs = _scan_motion(params, frames_u8, key, estimate)
    return jnp.concatenate([logs, jnp.zeros((1, 3, 3), jnp.float32)], axis=0)


def _stabilize_clip_homography(frames: np.ndarray,
                               params: StabilizerParams) -> np.ndarray:
    from video_stab_tpu.motion.homography import smooth_homography_path

    t, h, w = frames.shape[:3]
    dev_frames = jnp.asarray(frames)
    logs = _analyze_clip_homography(params, dev_frames,
                                    jax.random.PRNGKey(params.seed))
    corr_h = smooth_homography_path(
        logs, lambda path: _smooth_path(params, path))

    from video_stab_tpu.ops.warp import warp_perspective_fast

    def one(frame_u8, hm):
        out = warp_perspective_fast(frame_u8, hm,
                                    border_mode=BORDER_CONSTANT)
        return saturate_u8(out)

    # Jitted ONCE outside the chunk loop — a fresh jit(vmap(...)) object
    # per chunk would retrace the identical program every 8 frames.
    warp_chunk = jax.jit(jax.vmap(one))

    outs = []
    for start in range(0, t, WARP_CHUNK):
        end = min(start + WARP_CHUNK, t)
        chunk = dev_frames[start:end]
        hs = corr_h[start:end]
        pad = WARP_CHUNK - (end - start)
        if pad:
            chunk = jnp.pad(chunk, ((0, pad), (0, 0), (0, 0), (0, 0)))
            hs = jnp.pad(hs, ((0, pad), (0, 0), (0, 0)))
            hs = hs.at[end - start:].set(jnp.eye(3))
        res = warp_chunk(chunk, hs)
        outs.append(np.asarray(res[:end - start]))
    return np.concatenate(outs, axis=0)


def stabilize_clip(frames: np.ndarray,
                   params: StabilizerParams = StabilizerParams(),
                   ) -> np.ndarray:
    """Batch-stabilize a whole clip. frames: (T, H, W, 3) uint8 BGR."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if params.motion_model == "homography":
        return _stabilize_clip_homography(frames, params)
    t, h, w = frames.shape[:3]
    dev_frames = jnp.asarray(frames)

    raws = _analyze_clip(params, dev_frames, jax.random.PRNGKey(params.seed))
    path = jnp.cumsum(raws, axis=0)
    smoothed = _smooth_path(params, path)
    corrections = raws + (smoothed - path)
    if params.horizon_lock:
        corrections = corrections.at[:, 2].set(0.0)
    if params.full_res_corrections:
        # Analysis-px -> full-frame-px translation at application (the
        # streaming path does the same at emit — see
        # StabilizerParams.full_res_corrections and core/stabilizer.py).
        sxo = w / params.analysis_width
        syo = h / params.analysis_height
        if sxo != 1.0 or syo != 1.0:
            corrections = corrections * jnp.asarray(
                [sxo, syo, 1.0], jnp.float32)

    b = params.border_pad

    @jax.jit
    def warp_chunk(chunk_u8, corr):
        def one(frame_u8, c):
            f = frame_u8
            if b > 0 and not params.crop_n_zoom:
                f = jnp.pad(f, ((b, b), (b, b), (0, 0)))
            m = similarity_matrix(c[0], c[1], c[2])
            out = warp_affine_fast(f, m, border_mode=BORDER_CONSTANT)
            if params.crop_n_zoom and b > 0:
                out = resize_bilinear(out[b:h - b, b:w - b], h, w)
            return saturate_u8(out)
        return jax.vmap(one)(chunk_u8, corr)

    outs = []
    for start in range(0, t, WARP_CHUNK):
        end = min(start + WARP_CHUNK, t)
        chunk = dev_frames[start:end]
        corr = corrections[start:end]
        pad = WARP_CHUNK - (end - start)
        if pad:
            chunk = jnp.pad(chunk, ((0, pad), (0, 0), (0, 0), (0, 0)))
            corr = jnp.pad(corr, ((0, pad), (0, 0)))
        res = warp_chunk(chunk, corr)
        outs.append(np.asarray(res[:end - start]))
    return np.concatenate(outs, axis=0)
