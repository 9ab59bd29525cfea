"""Sparse pyramidal Lucas-Kanade optical flow — matmul formulation.

Counterpart of cv::calcOpticalFlowPyrLK / cuda::SparsePyrLKOpticalFlow
(reference: src/Stabilizer.cpp:122-125, 496-504, 611-619 — 15x15 window,
maxLevel 2, 20 iterations, eps 0.03; src/Stabilizer_legacy.cpp:218-224 —
21x21 window, maxLevel 3, 30 iterations, eps 0.01).

The tracker is fully static-shape: a fixed point capacity with a validity
mask, fixed iteration counts with eps early-out via masking, batched over
points.

Sampling: windows are never gathered. Per pyramid level, a per-point
source SLAB (big enough to cover the window plus the whole iteration drift
budget) is extracted with ONE-HOT row/column selection matmuls — `slab =
onehot_rows @ img @ onehot_cols` batched over points — a formulation chosen
where per-element gathers were slow. Sub-pixel bilinear windows then come
from separable hat-function interpolation matrices — two more tiny batched
matmuls per iteration. Index clamping in the one-hot build reproduces
replicate-border (BORDER_REFLECT_101-free) semantics exactly, so no
host-side padding pass exists at all. Full budget: ~35 GFLOP-equivalent of
matmul work per frame pair. Whether a gather formulation is faster on the
GPU is open (ROADMAP.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from video_stab_tpu.ops.filters import scharr_derivs
from video_stab_tpu.ops.resize import build_pyramid

# Iteration drift budget per pyramid level (px). The slab covers the window
# wherever the guess wanders within +-DRIFT of its starting position at that
# level; beyond it the window clamps to the slab edge and the point is
# caught by the err/min-eig/inside filters. Levels below the top start from
# the upsampled coarser estimate (residual ~1-2 px); the TOP level starts
# from a no-motion guess and must absorb the full motion at top-level
# scale, so it gets a larger budget (24 px at 1/4 res = ~96 px full-res
# motion — beyond any stabilizable shake).
DRIFT = 8
DRIFT_TOP = 24


def _slab_select(img: jnp.ndarray, y0: jnp.ndarray, x0: jnp.ndarray,
                 s: int) -> jnp.ndarray:
    """Batched s x s slab extraction at integer offsets via one-hot matmuls.

    img: (H, W) or (C, H, W); y0/x0: (N,) int32 top-left corners (may be
    out of range — indices clamp, giving replicate-border semantics).
    Returns (N, s, s) or (N, C, s, s).
    """
    imgs = img[None] if img.ndim == 2 else img            # (C, H, W)
    ch, h, w = imgs.shape
    ss = jnp.arange(s, dtype=jnp.int32)
    ry = jnp.clip(y0[:, None] + ss[None, :], 0, h - 1)     # (N, s)
    rx = jnp.clip(x0[:, None] + ss[None, :], 0, w - 1)
    hh = jnp.arange(h, dtype=jnp.int32)
    ww = jnp.arange(w, dtype=jnp.int32)
    # Selection runs in bf16 (the dominant matmul: (N,s,H) x
    # (C,H,W) over the full level-0 plane). One-hot weights are exact in
    # any dtype; image values round to bf16 (ulp is 1.0 for values in
    # [128,256), so fractional pyramid-level values round by <=0.5
    # u8-levels) — below LK's noise floor, at the bf16 matmul rate.
    # Accumulation stays f32.
    oh = (ry[:, :, None] == hh[None, None, :]).astype(jnp.bfloat16)
    ow = (rx[:, :, None] == ww[None, None, :]).astype(jnp.bfloat16)
    # rows: (N,s,H) @ (C,H,W) -> (N,C,s,W); cols: -> (N,C,s,s)
    rows = jnp.einsum("nsh,chw->ncsw", oh, imgs.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    slab = jnp.einsum("ncsw,ntw->ncst", rows.astype(jnp.bfloat16), ow,
                      preferred_element_type=jnp.float32)
    return slab[:, 0] if img.ndim == 2 else slab


def _hat_weights(c: jnp.ndarray, win: int, s: int) -> jnp.ndarray:
    """(N, win, s) separable bilinear weights: W[n,i,a] = hat(c_n + i - a).
    Exactly two taps per output row; exact bilinear interpolation."""
    i = jnp.arange(win, dtype=jnp.float32)[None, :, None]
    a = jnp.arange(s, dtype=jnp.float32)[None, None, :]
    return jnp.maximum(0.0, 1.0 - jnp.abs(c[:, None, None] + i - a))


def _interp_window(slab: jnp.ndarray, cy: jnp.ndarray, cx: jnp.ndarray,
                   win: int) -> jnp.ndarray:
    """Sub-pixel win x win window from (N,[C,]s,s) slabs at fractional
    in-slab offsets (cy, cx): two batched interpolation matmuls."""
    s = slab.shape[-1]
    wy = _hat_weights(cy, win, s)                          # (N, win, s)
    wx = _hat_weights(cx, win, s)
    if slab.ndim == 4:
        t = jnp.einsum("nia,ncab->ncib", wy, slab,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.einsum("njb,ncib->ncij", wx, t,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
    t = jnp.einsum("nia,nab->nib", wy, slab,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("njb,nib->nij", wx, t,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def global_translation_prior(prev_small: jnp.ndarray,
                             curr_small: jnp.ndarray,
                             search: int = 24) -> jnp.ndarray:
    """Coarse global translation (dx, dy) between two small grayscale
    frames via zero-mean center-patch correlation — ONE tiny conv.

    The stabilizer's inter-frame motion is dominated by a global shift
    (shake); seeding LK with it keeps the top-level Newton solve inside
    its convergence basin, so the early-exit fires. (A constant-velocity
    prior from the previous transform does worse than no prior: shake is
    anti-correlated frame-to-frame, so "same as last time" lands OUTSIDE
    the basin.)

    Confidence-gated: on flat/ambiguous content the correlation peak is
    not significant (z-score of the peak against the correlation surface)
    and the prior falls back to 0 — never worse than the no-prior path.
    """
    h, w = prev_small.shape
    patch = min(64, ((min(h, w) // 2) // 8) * 8)
    search = min(search, (h - patch) // 2 - 1, (w - patch) // 2 - 1)
    if search < 4 or patch < 16:
        return jnp.zeros(2, jnp.float32)
    cy = (h - patch) // 2
    cx = (w - patch) // 2
    p = jax.lax.dynamic_slice(prev_small, (cy, cx), (patch, patch))
    p = p - jnp.mean(p)
    region = jax.lax.dynamic_slice(
        curr_small, (cy - search, cx - search),
        (patch + 2 * search, patch + 2 * search))
    region = region - jnp.mean(region)
    n = 2 * search + 1
    # Channelized correlation: a single-channel KxK spatial conv pads its
    # channel axis; putting the patch ROWS on the input-channel axis makes
    # the contraction patch*patch wide — the same 10 MFLOPs as one wide
    # product.
    rows = jnp.stack([region[i:i + n, :] for i in range(patch)])
    corr = jax.lax.conv_general_dilated(
        rows[None], p[None, :, None, :], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)[0, 0]   # (n, n)
    idx = jnp.argmax(corr)
    peak = corr.reshape(-1)[idx]
    z = (peak - jnp.mean(corr)) / jnp.maximum(jnp.std(corr), 1e-6)
    dy = (idx // n - search).astype(jnp.float32)
    dx = (idx % n - search).astype(jnp.float32)
    confident = z > 4.0
    return jnp.where(confident, jnp.stack([dx, dy]),
                     jnp.zeros(2, jnp.float32))


@functools.partial(jax.jit, static_argnames=("win", "max_level", "iters"))
def lk_track(prev_gray: jnp.ndarray, curr_gray: jnp.ndarray,
             prev_pts: jnp.ndarray, pts_mask: jnp.ndarray,
             win: int = 15, max_level: int = 2, iters: int = 20,
             eps: float = 0.03, min_eig_thresh: float = 1e-4,
             init_pts: jnp.ndarray | None = None,
             ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Track ``prev_pts`` from prev_gray to curr_gray.

    Args:
      prev_gray/curr_gray: (H, W) float32 u8-domain grayscale.
      prev_pts: (N, 2) float32 (x, y).
      pts_mask: (N,) bool validity of inputs.
      init_pts: optional (N, 2) initial position guesses (cv2's
        OPTFLOW_USE_INITIAL_FLOW): a motion prior for content whose
        inter-frame motion exceeds the top-level drift budget (fast pans)
        — primarily a ROBUSTNESS lever; on ordinary shake the no-prior
        top level already converges.

    Returns:
      curr_pts: (N, 2) float32 tracked positions.
      status:   (N,) bool — tracked successfully and inside the image.
      err:      (N,) float32 — mean abs intensity diff over the final window
                (OpenCV's default err output; used by the legacy path's
                err < 30 filter, Stabilizer_legacy.cpp:228-233).
    """
    h, w = curr_gray.shape
    prev_pyr = build_pyramid(prev_gray, max_level)
    curr_pyr = build_pyramid(curr_gray, max_level)
    half = (win - 1) * 0.5
    s_t = win + 1                       # template slab: window + 1 (frac)

    scale_top = 1.0 / (2 ** max_level)
    start = prev_pts if init_pts is None else init_pts
    guess = start * scale_top           # (N, 2)
    ok = pts_mask
    err = jnp.zeros(prev_pts.shape[0], jnp.float32)

    for level in range(max_level, -1, -1):
        drift = DRIFT_TOP if level == max_level else DRIFT
        s_c = win + 1 + 2 * drift       # current slab: + iteration drift
        prev_l = prev_pyr[level]
        curr_l = curr_pyr[level]
        ix, iy = scharr_derivs(prev_l)
        stk = jnp.stack([prev_l, ix, iy])                  # (3, Hl, Wl)

        # Template: fixed sub-pixel window around pt_prev at this level.
        pt_prev = prev_pts / (2 ** level)
        ty0 = jnp.floor(pt_prev[:, 1] - half).astype(jnp.int32)
        tx0 = jnp.floor(pt_prev[:, 0] - half).astype(jnp.int32)
        t_slab = _slab_select(stk, ty0, tx0, s_t)          # (N,3,s_t,s_t)
        tcy = pt_prev[:, 1] - half - ty0.astype(jnp.float32)
        tcx = pt_prev[:, 0] - half - tx0.astype(jnp.float32)
        tmpl = _interp_window(t_slab, tcy, tcx, win)       # (N,3,win,win)
        i_win, ix_win, iy_win = tmpl[:, 0], tmpl[:, 1], tmpl[:, 2]

        # Spatial gradient matrix + trackability (cv2's minEigThreshold).
        g_stack = tmpl[:, 1:]                              # (N,2,win,win)
        g11 = jnp.sum(ix_win * ix_win, axis=(1, 2))
        g12 = jnp.sum(ix_win * iy_win, axis=(1, 2))
        g22 = jnp.sum(iy_win * iy_win, axis=(1, 2))
        det = g11 * g22 - g12 * g12
        half_tr = 0.5 * (g11 + g22)
        min_eig = half_tr - jnp.sqrt(
            jnp.maximum(half_tr * half_tr - det, 0.0))
        lvl_ok = (det > 1e-7) & (min_eig / (win * win) > min_eig_thresh)
        safe_det = jnp.where(lvl_ok, det, 1.0)
        inv11 = jnp.where(lvl_ok, g22 / safe_det, 0.0)
        inv12 = jnp.where(lvl_ok, -g12 / safe_det, 0.0)
        inv22 = jnp.where(lvl_ok, g11 / safe_det, 0.0)

        # Current-frame slab covering the iteration drift budget. The
        # window must follow the guess (cv2 semantics): a Newton overshoot
        # beyond the slab would otherwise pin the window at the clamp and
        # converge to garbage — so iterations run in ROUNDS, re-fetching
        # the slab at the current guess between rounds (the budget
        # resets). The top level absorbs the full unknown motion and gets
        # several rounds; its image is the smallest, so refetches are
        # nearly free.
        # The top level starts far off (no-motion guess) and gets the most
        # rounds; inner levels start within ~1-2 px but weak-gradient
        # content can still overshoot once, so they get one refetch.
        rounds = 4 if level == max_level else 2
        iters_per = -(-iters // rounds)

        def run_round(carry, _):
            pt0, done0 = carry
            return jax.lax.cond(jnp.all(done0), lambda c: (c, ()),
                                _run_round_live, (pt0, done0))

        def _run_round_live(carry):
            # Skipped entirely (no slab re-fetch matmuls) once every point
            # has converged — later rounds then cost one branch.
            pt0, done0 = carry
            cy0 = jnp.floor(pt0[:, 1] - half).astype(jnp.int32) - drift
            cx0 = jnp.floor(pt0[:, 0] - half).astype(jnp.int32) - drift
            c_slab = _slab_select(curr_l, cy0, cx0, s_c)   # (N,s_c,s_c)

            # One Newton step, op-count-minimized: the serial iteration
            # chain is bound by per-op fixed cost (tools/lk_op_probe.py),
            # not MACs — so both hat-weight builds
            # fuse into ONE broadcast op and the two image-residual
            # reductions into ONE einsum against the stacked gradients.
            ii = jnp.arange(win, dtype=jnp.float32)[None, None, :, None]
            aa = jnp.arange(s_c, dtype=jnp.float32)[None, None, None, :]

            def newton(pt, done):
                cy = jnp.clip(pt[:, 1] - half - cy0.astype(jnp.float32),
                              0.0, s_c - win - 1.0)
                cx = jnp.clip(pt[:, 0] - half - cx0.astype(jnp.float32),
                              0.0, s_c - win - 1.0)
                c2 = jnp.stack([cy, cx], axis=1)[:, :, None, None]
                wyx = jnp.maximum(0.0, 1.0 - jnp.abs(c2 + ii - aa))
                t = jnp.einsum("nia,nab->nib", wyx[:, 0], c_slab,
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)
                j_win = jnp.einsum("njb,nib->nij", wyx[:, 1], t,
                                   preferred_element_type=jnp.float32,
                                   precision=jax.lax.Precision.HIGHEST)
                b = jnp.einsum("nij,ncij->nc", j_win - i_win, g_stack,
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)
                dx = -(inv11 * b[:, 0] + inv12 * b[:, 1])
                dy = -(inv12 * b[:, 0] + inv22 * b[:, 1])
                step = jnp.where(done, 0.0, 1.0)[:, None]
                new_pt = pt + step * jnp.stack([dx, dy], axis=-1)
                done = done | (dx * dx + dy * dy <= eps * eps)
                return new_pt, done

            def cond(carry):
                # Early exit once EVERY live point converged (cv2's eps
                # criterion) — typical content converges in 3-5 Newton
                # steps, and the iteration body is op-dispatch-bound, so
                # running the full fixed budget wastes most of the level's
                # time. Output-identical: converged points are frozen by
                # the step mask either way.
                i, pt, done = carry
                return (i < iters_per) & ~jnp.all(done)

            def body(carry):
                # FIVE Newton steps per trip: the loop is budget-bound on
                # real content (one straggler point holds every level at
                # its full budget — tools/lk_budget_probe.py), so amortize
                # the while_loop's fixed per-trip cost (cond eval + carry
                # shuffle) over a round's whole step budget. Substeps past
                # the budget are select-masked (exact cv2 iteration-count
                # semantics); past convergence they are frozen no-ops.
                i, pt, done = carry
                pt, done = newton(pt, done)
                for k in range(1, 5):
                    pt_k, done_k = newton(pt, done)
                    in_budget = (i + k) < iters_per
                    pt = jnp.where(in_budget, pt_k, pt)
                    done = jnp.where(in_budget, done_k, done)
                return i + 5, pt, done

            _, pt1, done1 = jax.lax.while_loop(
                cond, body, (jnp.int32(0), pt0, done0))
            return (pt1, done1), ()

        (new_pt, _), _ = jax.lax.scan(run_round, (guess, ~lvl_ok),
                                      None, length=rounds)
        ok = ok & lvl_ok
        guess = jnp.where(ok[:, None], new_pt, guess)
        if level > 0:
            guess = guess * 2.0
        else:
            # Final-window error (OpenCV's err output): fresh slab at the
            # converged position.
            ey0 = jnp.floor(guess[:, 1] - half).astype(jnp.int32) - 1
            ex0 = jnp.floor(guess[:, 0] - half).astype(jnp.int32) - 1
            e_slab = _slab_select(curr_l, ey0, ex0, win + 3)
            j_win = _interp_window(
                e_slab,
                guess[:, 1] - half - ey0.astype(jnp.float32),
                guess[:, 0] - half - ex0.astype(jnp.float32), win)
            err = jnp.mean(jnp.abs(j_win - i_win), axis=(1, 2))

    inside = ((guess[:, 0] >= 0) & (guess[:, 0] <= w - 1) &
              (guess[:, 1] >= 0) & (guess[:, 1] <= h - 1))
    return guess, ok & inside, err
