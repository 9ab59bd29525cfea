"""Hough line transform with a fixed-capacity line list.

Counterpart of cv::cuda::createHoughLinesDetector
(reference: src/RollCorrection.cpp:66-73 — rho 1.0, theta pi/180,
threshold 100). The (rho, theta) accumulator is built with a vectorized
scatter-add over all pixels weighted by the edge mask (no data-dependent
shapes); peaks are 4-neighbour local maxima over the accumulator and the
top-K by votes are returned with a validity mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("rho", "theta", "max_lines",
                                             "theta_range", "impl",
                                             "max_edges"))
def hough_lines(edges: jnp.ndarray, rho: float = 1.0,
                theta: float = float(jnp.pi) / 180.0, threshold: int = 100,
                max_lines: int = 256,
                theta_range: tuple | None = None,
                impl: str = "auto",
                max_edges: int = 16384,
                ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Detect lines in a binary edge map.

    Args:
      edges: (H, W) edge map; any value > 0 counts as an edge pixel.
      theta_range: optional (lo, hi) radians — restrict the accumulator to
        thetas in [lo, hi], for consumers that post-filter to an angle
        window anyway (roll correction keeps only near-horizontal lines,
        RollCorrection.cpp:113-119): votes per (rho, theta) cell and the
        theta-direction peak test are local, so cells outside the window
        (plus a one-bin margin, included automatically; margin-bin peaks
        are masked out of the line slots) influence nothing that survives
        the filter. Per-line (rho, theta, votes) triplets are EXACT; the
        top-``max_lines`` COMPETITION runs within the window only — a
        full-sweep accumulator lets strong out-of-window peaks crowd
        in-window lines out of the top-k (a reference limitation this
        path deliberately does not reproduce: post-filter consumers get
        MORE in-window lines and a better-conditioned angle estimate;
        identical whenever total peak count <= max_lines). The full
        180-bin sweep is a per-pixel scatter-add over every theta; the
        23-bin window does ~8x less of that work.
      impl: "auto" — when the frame has <= max_edges edge pixels (the
        typical case: Canny keeps a few percent), compact them with one
        top_k and run ONE batched one-hot einsum over all thetas — exact,
        and it replaces the serial per-theta lax.map over every pixel.
        An in-graph lax.cond falls back to the dense sweep when edges
        overflow the capacity, so results are exact either way. "dense"
        pins the per-theta full-pixel sweep (for VMAPPED callers, where a
        batched-predicate cond runs both branches).
      max_edges: sparse-path capacity (static).

    Returns:
      lines: (max_lines, 2) float32 rows of (rho, theta), vote-descending.
      votes: (max_lines,) float32 accumulator votes.
      mask:  (max_lines,) bool — True where votes > threshold.
    """
    h, w = edges.shape
    n_theta_full = int(round(jnp.pi / theta))
    if theta_range is not None:
        import math as _math
        t0 = max(0, int(_math.floor(float(theta_range[0]) / theta)) - 1)
        t1 = min(n_theta_full - 1,
                 int(_math.ceil(float(theta_range[1]) / theta)) + 1)
    else:
        t0, t1 = 0, n_theta_full - 1
    n_theta = t1 - t0 + 1
    n_rho = int(round(((w + h) * 2 + 1) / rho))
    center = (n_rho - 1) // 2

    thetas = (jnp.arange(n_theta, dtype=jnp.float32) + t0) * theta
    cos_t = jnp.cos(thetas) / rho
    sin_t = jnp.sin(thetas) / rho

    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    weight = (edges > 0).astype(jnp.bfloat16).reshape(-1)

    # Histogram as a TWO-LEVEL one-hot matmul instead of a scatter-add
    # (a formulation chosen where scatters serialized). Split the rho
    # index r = 128*hi + lo; then acc[hi, lo] = sum_p w_p * onehot_hi(p)
    # * onehot_lo(p) is one (n_hi, P) x (P, 128) matmul per theta —
    # matmul work with small one-hots. Counts are exact: one-hots and 0/1
    # weights are exact in bf16; f32 accumulation is integer-exact far
    # beyond any pixel count here.
    n_hi = -(-n_rho // 128)

    def one_theta(ct_st):
        ct, st = ct_st
        ridx = jnp.round(xs * ct + ys * st).astype(jnp.int32) + center
        r = jnp.clip(ridx.reshape(-1), 0, n_hi * 128 - 1)
        hi = r // 128
        lo = r % 128
        whi = (hi[:, None] == jnp.arange(n_hi)[None, :]
               ).astype(jnp.bfloat16) * weight[:, None]
        wlo = (lo[:, None] == jnp.arange(128)[None, :]).astype(jnp.bfloat16)
        a = jnp.einsum("ph,pl->hl", whi, wlo,
                       preferred_element_type=jnp.float32)
        return a.reshape(-1)[:n_rho]

    def dense_acc(_):
        return jax.lax.map(one_theta, (cos_t, sin_t))  # (n_theta, n_rho)

    def make_sparse_acc(cap):
        def sparse_acc(_):
            # Compact edge coordinates with one top_k over the 0/1 edge
            # plane: descending-value + ascending-index ordering returns
            # ALL edge indices (in raster order) whenever count <= cap —
            # the case the guard admits — padded with weight-0 entries
            # that vote into a clipped bin with weight 0, contributing
            # nothing.
            wf = weight.astype(jnp.float32)
            vals, idx = jax.lax.top_k(wf, cap)             # (K,)
            px = (idx % w).astype(jnp.float32)
            py = (idx // w).astype(jnp.float32)
            # All thetas in ONE batched one-hot einsum: the serial
            # per-theta map walks every pixel per theta; here each theta's
            # histogram contracts only the K compacted points.
            ridx = jnp.round(px[None, :] * cos_t[:, None]
                             + py[None, :] * sin_t[:, None]
                             ).astype(jnp.int32) + center   # (T, K)
            r = jnp.clip(ridx, 0, n_hi * 128 - 1)
            hi = r // 128
            lo = r % 128
            # int8 one-hots with i32 accumulation: the cost here is
            # MATERIALIZING the (T, K, n_hi + 128) one-hot operands, not
            # the matmul — i8 halves that traffic vs bf16, and 0/1
            # weights make every count integer-exact in i32.
            whi = (hi[:, :, None] == jnp.arange(n_hi)[None, None, :]
                   ).astype(jnp.int8) \
                * vals.astype(jnp.int8)[None, :, None]
            wlo = (lo[:, :, None] == jnp.arange(128)[None, None, :]
                   ).astype(jnp.int8)
            a = jnp.einsum("tph,tpl->thl", whi, wlo,
                           preferred_element_type=jnp.int32)
            return a.astype(jnp.float32).reshape(
                n_theta, n_hi * 128)[:, :n_rho]
        return sparse_acc

    if impl == "dense" or max_edges >= h * w:
        acc = dense_acc(None)
    else:
        # Staged capacity: the histogram einsums scale with the edge
        # CAPACITY, not the actual edge count, so try a quarter-capacity
        # pass first — typical roll-correction frames carry ~4-5k edges
        # against the 16k default. Every stage is guarded by the exact
        # count, so the result is identical whichever branch runs.
        n_edges = jnp.sum((edges > 0).astype(jnp.int32))
        cap_s = max_edges // 4
        cap_m = max_edges // 2

        def full_or_dense(_):
            return jax.lax.cond(n_edges <= max_edges,
                                make_sparse_acc(max_edges), dense_acc,
                                None)

        def mid_or_full(_):
            # Half-capacity rung: typical roll frames carry 4-8k edges
            # against the 16k cap — without this rung they fall straight
            # from the quarter cap to the FULL table (4x the one-hot
            # traffic of what the count needs).
            return jax.lax.cond(n_edges <= cap_m, make_sparse_acc(cap_m),
                                full_or_dense, None)

        if cap_s >= 128:
            acc = jax.lax.cond(n_edges <= cap_s, make_sparse_acc(cap_s),
                               mid_or_full, None)
        else:
            acc = full_or_dense(None)
    acc = acc.T  # (n_rho, n_theta)

    # 4-neighbour local maxima (matching OpenCV's > left/up, >= right/down).
    up = jnp.pad(acc[:-1, :], ((1, 0), (0, 0)))
    down = jnp.pad(acc[1:, :], ((0, 1), (0, 0)))
    left = jnp.pad(acc[:, :-1], ((0, 0), (1, 0)))
    right = jnp.pad(acc[:, 1:], ((0, 0), (0, 1)))
    is_peak = (acc > up) & (acc >= down) & (acc > left) & (acc >= right)
    peak_votes = jnp.where(is_peak, acc, 0.0)
    if theta_range is not None:
        # The one-bin margin exists so window-edge peaks see their true
        # neighbours; margin-bin peaks themselves must not consume
        # top-max_lines slots (they are outside the requested range and
        # would crowd out in-range lines).
        tcol = jnp.arange(n_theta) + t0
        in_range = (tcol * theta >= float(theta_range[0]) - 1e-9) \
            & (tcol * theta <= float(theta_range[1]) + 1e-9)
        peak_votes = jnp.where(in_range[None, :], peak_votes, 0.0)

    k = min(max_lines, n_rho * n_theta)
    votes, idx = jax.lax.top_k(peak_votes.reshape(-1), k)
    r_idx = idx // n_theta
    t_idx = idx % n_theta
    line_rho = (r_idx - center).astype(jnp.float32) * rho
    line_theta = (t_idx + t0).astype(jnp.float32) * theta
    lines = jnp.stack([line_rho, line_theta], axis=-1)
    mask = votes > threshold
    if k < max_lines:
        pad = max_lines - k
        lines = jnp.pad(lines, ((0, pad), (0, 0)))
        votes = jnp.pad(votes, (0, pad))
        mask = jnp.pad(mask, (0, pad))
    return lines, votes, mask
