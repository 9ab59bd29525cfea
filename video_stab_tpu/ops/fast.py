"""FAST corner detection (+ ORB/BRISK-style rescoring) with static shapes.

Counterpart of the reference's alternative feature detectors
(detectFeatures, src/Stabilizer.cpp:1194-1266: GFTT | ORB | FAST | BRISK).

FAST-9/16 fully vectorized: the 16 Bresenham-circle neighbors are 16 shifted
images; the >=9-contiguous-arc test is an OR over 16 rotations of an AND
over 9 consecutive comparisons — pure VPU elementwise work. Score is
OpenCV's sum-of-absolute-differences over the qualifying arc pixels
(simplified to the full circle SAD for ranking).

- ORB keypoints are FAST corners re-ranked by the Harris response
  (cv::ORB's HARRIS_SCORE default).
- BRISK's AGAST detector is approximated by FAST on two pyramid scales.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from video_stab_tpu.ops.features import min_eig_response
from video_stab_tpu.ops.resize import pyr_down

# Bresenham circle of radius 3 (OpenCV's FAST-16 offsets, clockwise from top).
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _shift(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """img value at (x+dx, y+dy), replicate border."""
    h, w = img.shape
    p = jnp.pad(img, 3, mode="edge")
    return jax.lax.slice(p, (3 + dy, 3 + dx), (3 + dy + h, 3 + dx + w))


def fast_response(gray: jnp.ndarray, threshold: float = 10.0,
                  arc: int = 9) -> jnp.ndarray:
    """FAST-N/16 corner response map; 0 where not a corner."""
    neigh = jnp.stack([_shift(gray, dx, dy) for dx, dy in _CIRCLE])  # (16,H,W)
    brighter = neigh > (gray + threshold)[None]
    darker = neigh < (gray - threshold)[None]

    def has_arc(mask):
        # >= arc contiguous True around the 16-cycle.
        acc = jnp.zeros_like(mask[0], dtype=bool)
        doubled = jnp.concatenate([mask, mask], axis=0)
        for s in range(16):
            run = doubled[s]
            for k in range(1, arc):
                run = run & doubled[s + k]
            acc = acc | run
        return acc

    is_corner = has_arc(brighter) | has_arc(darker)
    sad = jnp.sum(jnp.maximum(jnp.abs(neigh - gray[None]) - threshold, 0.0),
                  axis=0)
    return jnp.where(is_corner, sad, 0.0)


def _nms_topk(resp: jnp.ndarray, max_corners: int, min_distance: float,
              n_candidates: int = 1024):
    """3x3 NMS + greedy min-distance top-K (shared with GFTT's scaffold).

    Greedy selection runs as parallel frontier rounds (_nms_compact,
    ops/features.py) — exact same result as candidate-by-candidate greedy,
    but a handful of (n, n) masked-any rounds instead of n_candidates tiny
    sequential fori_loop steps (DESIGN.md's GFTT rework)."""
    from video_stab_tpu.ops.features import _nms_compact

    h, w = resp.shape
    neigh = resp
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                continue
            neigh = jnp.maximum(neigh, jnp.roll(resp, (-dy, -dx), (0, 1)))
    cand = jnp.where((resp >= neigh) & (resp > 0.0), resp, -1.0)
    n_cand = min(n_candidates, h * w)
    top_vals, top_idx = jax.lax.top_k(cand.reshape(-1), n_cand)
    pts, mask, _ = _nms_compact(top_vals, top_idx, w, max_corners,
                                min_distance)
    return pts, mask


@functools.partial(jax.jit, static_argnames=("max_corners",))
def fast_corners(gray: jnp.ndarray, threshold: float = 10.0,
                 max_corners: int = 200, min_distance: float = 7.0,
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FAST keypoints: (max_corners, 2) xy + validity mask."""
    return _nms_topk(fast_response(gray, threshold), max_corners,
                     min_distance)


@functools.partial(jax.jit, static_argnames=("max_corners",))
def orb_corners(gray: jnp.ndarray, threshold: float = 10.0,
                max_corners: int = 200, min_distance: float = 7.0,
                ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """ORB keypoints: FAST corners re-ranked by Harris/min-eig response."""
    fresp = fast_response(gray, threshold)
    harris = min_eig_response(gray, 3)
    resp = jnp.where(fresp > 0.0, jnp.maximum(harris, 1e-9), 0.0)
    return _nms_topk(resp, max_corners, min_distance)


@functools.partial(jax.jit, static_argnames=("max_corners",))
def brisk_corners(gray: jnp.ndarray, threshold: float = 10.0,
                  max_corners: int = 200, min_distance: float = 7.0,
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """BRISK-style keypoints: FAST over two pyramid scales (AGAST approx)."""
    r0 = fast_response(gray, threshold)
    small = pyr_down(gray)
    r1 = fast_response(small, threshold)
    # Upsample coarse response to full res (nearest) and take the max.
    r1_up = jnp.repeat(jnp.repeat(r1, 2, axis=0), 2, axis=1)
    r1_up = r1_up[:r0.shape[0], :r0.shape[1]]
    ph = r0.shape[0] - r1_up.shape[0]
    pw = r0.shape[1] - r1_up.shape[1]
    if ph or pw:
        r1_up = jnp.pad(r1_up, ((0, ph), (0, pw)))
    return _nms_topk(jnp.maximum(r0, r1_up), max_corners, min_distance)
