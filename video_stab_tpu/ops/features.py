"""Shi-Tomasi corner detection with fixed-capacity outputs.

Counterpart of cv::goodFeaturesToTrack / cv::cuda::CornersDetector
(reference: src/Stabilizer.cpp:339-359, 739-745; src/Stabilizer_legacy.cpp:167-176).

Everything is static-shape: the detector returns exactly ``max_corners`` point
slots plus a validity mask, so the whole pipeline stays jit-compatible. The
min-distance greedy acceptance matches OpenCV's sorted-by-quality greedy scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from video_stab_tpu.ops.filters import sobel, sep_filter2d


def min_eig_response(gray: jnp.ndarray, block_size: int = 3,
                     aperture: int = 3) -> jnp.ndarray:
    """cv::cornerMinEigenVal: min eigenvalue of the structure tensor, with
    OpenCV's u8 normalization scale (1 / ((1 << (aperture-1)) * blockSize * 255)).
    """
    scale = 1.0 / ((1 << (aperture - 1)) * block_size * 255.0)
    gx, gy = sobel(gray, aperture)
    gx = gx * scale
    gy = gy * scale
    ones = tuple([1.0] * block_size)
    sxx = sep_filter2d(gx * gx, ones, ones)
    syy = sep_filter2d(gy * gy, ones, ones)
    sxy = sep_filter2d(gx * gy, ones, ones)
    half_tr = 0.5 * (sxx + syy)
    half_df = 0.5 * (sxx - syy)
    return half_tr - jnp.sqrt(half_df * half_df + sxy * sxy)


def _dilate3x3(x: jnp.ndarray) -> jnp.ndarray:
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                continue
            out = jnp.maximum(out, jnp.roll(x, (-dy, -dx), axis=(0, 1)))
    return out


@functools.partial(jax.jit, static_argnames=("max_corners", "block_size",
                                             "n_candidates", "topk"))
def good_features_to_track(
    gray: jnp.ndarray,
    max_corners: int = 200,
    quality_level: float = 0.01,
    min_distance: float = 30.0,
    block_size: int = 3,
    roi: jnp.ndarray | None = None,
    n_candidates: int = 2048,
    topk: str = "auto",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """goodFeaturesToTrack with static shapes.

    Args:
      gray: (H, W) float32 u8-domain grayscale.
      roi: optional (4,) [x, y, w, h] int array; response outside is zeroed
           (the useROI path, Stabilizer.cpp:1197-1211).

    Returns:
      pts:  (max_corners, 2) float32 (x, y), quality-descending order.
      mask: (max_corners,) bool validity.
    """
    h, w = gray.shape
    resp = min_eig_response(gray, block_size)
    if roi is not None:
        ys = jnp.arange(h)[:, None]
        xs = jnp.arange(w)[None, :]
        inside = ((xs >= roi[0]) & (xs < roi[0] + roi[2]) &
                  (ys >= roi[1]) & (ys < roi[1] + roi[3]))
        resp = jnp.where(inside, resp, 0.0)
    max_val = jnp.max(resp)
    thresh = quality_level * max_val
    is_peak = resp >= _dilate3x3(resp)
    cand = jnp.where(is_peak & (resp > thresh), resp, -1.0)

    n_cand = min(n_candidates, h * w)
    # Candidate extraction. A flat top_k over the whole plane was the
    # single dominant cost of GFTT at 960x540. Two-stage EXACT replacement: per-row top-ROW_BUDGET
    # (cheap batched top_k over the 128-lane axis), then a global top_k
    # over the h*ROW_BUDGET survivors. Exact whenever no row holds more
    # than ROW_BUDGET candidates >= the reduced 2048th value — checked
    # in-graph; the rare violation falls back to the flat top_k via
    # lax.cond (one branch executes). Tie-breaking matches lax.top_k's
    # stable lowest-flat-index preference in both stages.
    # topk="flat" forces the single flat top_k — for VMAPPED callers,
    # where the guard's lax.cond (batched predicate) lowers to running
    # BOTH branches + select, costing more than either alone.
    ROW_BUDGET = 32
    N_FAST = 512
    flat = cand.reshape(-1)
    if topk == "flat" or h * ROW_BUDGET < n_cand or w <= ROW_BUDGET:
        top_vals, top_idx = jax.lax.top_k(flat, n_cand)
    elif topk == "staged":
        # VMAP-CLEAN single-branch variant (no lax.cond anywhere): the
        # exact two-stage extraction at the FULL n_cand budget, without
        # the flat-top_k fallback guard. Inexact only when some row holds
        # more than ROW_BUDGET candidates above the global n_cand-th
        # value; each candidate dropped then is dominated by >= ROW_BUDGET
        # stronger same-row candidates, most of which the min-distance NMS
        # would have used to suppress it anyway — a bounded, redetect-only
        # deviation that batched serving accepts in exchange for not
        # running both cond branches under vmap (DESIGN.md 5c).
        rv, ri = jax.lax.top_k(cand, ROW_BUDGET)          # (h, B)
        flat_v = rv.reshape(-1)
        flat_i = (jnp.arange(h, dtype=jnp.int32)[:, None] * w
                  + ri).reshape(-1)
        top_vals, stage2 = jax.lax.top_k(flat_v, n_cand)
        top_idx = flat_i[stage2]
    else:
        rv, ri = jax.lax.top_k(cand, ROW_BUDGET)          # (h, B)
        flat_v = rv.reshape(-1)
        flat_i = (jnp.arange(h, dtype=jnp.int32)[:, None] * w
                  + ri).reshape(-1)

        def full_budget(_):
            """The original exact two-stage path at the full n_cand
            budget (with its own flat-top_k guard)."""
            tv, ti = jax.lax.top_k(flat_v, n_cand)
            tau = tv[n_cand - 1]
            # Guard: with <= B per-row candidates >= tau, stage 1 kept
            # every global top-n_cand member (see the exactness argument
            # above). (cand > -1 term: when fewer than n_cand real
            # candidates exist, tau is the -1 fill and the guard must
            # count REAL candidates.)
            guard = jnp.any(
                jnp.sum((cand >= tau) & (cand > -1.0), axis=1)
                > ROW_BUDGET)
            tv2, ti2 = jax.lax.cond(
                guard,
                lambda _: tuple(jax.lax.top_k(flat, n_cand)),
                lambda _: (tv, flat_i[ti]),
                None)
            p, m, _n = _nms_compact(tv2, ti2, w, max_corners,
                                    min_distance)
            return p, m

        if n_cand > N_FAST and h * ROW_BUDGET >= N_FAST \
                and max_corners <= N_FAST:
            # Staged budget: the NMS conflict matrices are O(n_cand^2)
            # and the stage-2 top_k scales with its k, but greedy
            # selection of the first max_corners points depends ONLY on
            # higher-quality candidates — so a top-N_FAST run is EXACT
            # whenever it either fills max_corners slots or consumed
            # every real candidate. Both conditions (plus stage-1
            # row-budget sufficiency at the reduced tau) are checked
            # in-graph; violations re-run the full-budget path via
            # lax.cond (one branch executes).
            tvf, tif = jax.lax.top_k(flat_v, N_FAST)
            tauf = tvf[N_FAST - 1]
            real_per_row = jnp.sum((cand > -1.0), axis=1)
            row_guard = jnp.any(
                jnp.sum((cand >= tauf) & (cand > -1.0), axis=1)
                > ROW_BUDGET)
            ptsf, maskf, n_sel = _nms_compact(tvf, flat_i[tif], w,
                                              max_corners, min_distance)
            insufficient = (n_sel < max_corners) \
                & (jnp.sum(real_per_row) > N_FAST)
            return jax.lax.cond(row_guard | insufficient, full_budget,
                                lambda _: (ptsf, maskf), None)
        return full_budget(None)
    pts, mask, _ = _nms_compact(top_vals, top_idx, w, max_corners,
                                min_distance)
    return pts, mask


def _nms_compact(top_vals: jnp.ndarray, top_idx: jnp.ndarray, w: int,
                 max_corners: int, min_distance: float
                 ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Greedy min-distance selection over quality-ordered candidates +
    order-preserving compaction. Returns (pts, mask, n_selected_total —
    the UNtruncated selection count, used by the staged-budget exactness
    guard)."""
    n_cand = top_vals.shape[0]
    cand_x = (top_idx % w).astype(jnp.float32)
    cand_y = (top_idx // w).astype(jnp.float32)

    k = max_corners
    min_d2 = jnp.float32(min_distance * min_distance)

    # Greedy min-distance selection == the lexicographically-first maximal
    # independent set of the conflict graph under quality order. A
    # candidate-by-candidate fori_loop is 2048 tiny SEQUENTIAL steps;
    # instead resolve whole frontiers in parallel
    # rounds — exact same result, each round one (n, n) masked-any:
    #   SELECT i when every higher-ranked conflicting j is already
    #   suppressed; SUPPRESS i when a selected j conflicts with it.
    # Rounds needed = depth of the suppression DAG (typically < 10).
    valid = top_vals > 0.0
    d2 = ((cand_x[:, None] - cand_x[None, :]) ** 2
          + (cand_y[:, None] - cand_y[None, :]) ** 2)
    rank = jnp.arange(n_cand)
    conflict = (d2 < min_d2) & (rank[None, :] < rank[:, None]) \
        & valid[None, :]

    def round_body(state):
        unknown, selected, _ = state
        active = unknown | selected
        higher_active = jnp.any(conflict & active[None, :], axis=1)
        newly = unknown & ~higher_active
        selected = selected | newly
        suppressed = jnp.any(conflict & selected[None, :], axis=1)
        new_unknown = unknown & ~newly & ~suppressed
        return new_unknown, selected, jnp.any(new_unknown)

    def cond(state):
        return state[2]

    unknown0 = valid
    selected0 = jnp.zeros((n_cand,), bool)
    _, selected, _ = jax.lax.while_loop(
        cond, round_body, (unknown0, selected0, jnp.any(unknown0)))

    # Order-preserving compaction of the first k selections.
    pos = jnp.cumsum(selected.astype(jnp.int32)) - 1
    take = selected & (pos < k)
    idx = jnp.where(take, pos, k)            # k = discard slot
    pts = jnp.zeros((k + 1, 2), jnp.float32).at[idx].set(
        jnp.stack([cand_x, cand_y], axis=-1))[:k]
    mask = jnp.zeros((k + 1,), bool).at[idx].set(take)[:k]
    return pts, mask, jnp.sum(selected.astype(jnp.int32))
