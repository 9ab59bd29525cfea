"""Frame-to-frame motion estimation over masked fixed-capacity point sets.

Counterparts of:
- cv::estimateAffinePartial2D with RANSAC (reference: src/Stabilizer.cpp:564-566,
  647-649 — reprojection threshold 5.0 px, 500 iterations): a fully vectorized
  RANSAC over similarity (4-DOF) models — all hypotheses evaluated in parallel
  with a counter-based PRNG, then a closed-form least-squares refit on the best
  inlier set (for similarity models linear LSQ is the global optimum, so no
  iterative refinement is needed).
- the legacy closed-form centroid/atan2 rigid solve
  (src/Stabilizer_legacy.cpp:323-358).
- the legacy median-motion outlier rejection (src/Stabilizer_legacy.cpp:283-321).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def transform_params_from_matrix(m: jnp.ndarray) -> jnp.ndarray:
    """(dx, dy, da) from a 2x3 matrix: da = atan2(m10, m00)
    (Stabilizer.cpp:577-579)."""
    return jnp.stack([m[0, 2], m[1, 2], jnp.arctan2(m[1, 0], m[0, 0])])


def _similarity_from_two(p1, p2, q1, q2):
    """Exact similarity from two correspondences via complex ratio."""
    dp = p2 - p1
    dq = q2 - q1
    denom = dp[0] * dp[0] + dp[1] * dp[1]
    ok = denom > 1e-6
    safe = jnp.where(ok, denom, 1.0)
    # (a + i b) = dq / dp in complex form.
    a = (dq[0] * dp[0] + dq[1] * dp[1]) / safe
    b = (dq[1] * dp[0] - dq[0] * dp[1]) / safe
    tx = q1[0] - (a * p1[0] - b * p1[1])
    ty = q1[1] - (b * p1[0] + a * p1[1])
    return jnp.stack([a, b, tx, ty]), ok


def _similarity_lsq(prev: jnp.ndarray, curr: jnp.ndarray, w: jnp.ndarray):
    """Weighted least-squares similarity fit (global optimum for 4-DOF model)."""
    n = jnp.sum(w)
    ok = n >= 2.0
    safe_n = jnp.where(ok, n, 1.0)
    pm = jnp.sum(prev * w[:, None], axis=0) / safe_n
    qm = jnp.sum(curr * w[:, None], axis=0) / safe_n
    pc = (prev - pm) * w[:, None]
    qc = curr - qm
    dot = jnp.sum(pc[:, 0] * qc[:, 0] + pc[:, 1] * qc[:, 1])
    cross = jnp.sum(pc[:, 0] * qc[:, 1] - pc[:, 1] * qc[:, 0])
    norm = jnp.sum((prev - pm) ** 2 * w[:, None])
    safe_norm = jnp.where(norm > 1e-9, norm, 1.0)
    a = jnp.where(norm > 1e-9, dot / safe_norm, 1.0)
    b = jnp.where(norm > 1e-9, cross / safe_norm, 0.0)
    tx = qm[0] - (a * pm[0] - b * pm[1])
    ty = qm[1] - (b * pm[0] + a * pm[1])
    return jnp.stack([a, b, tx, ty]), ok


def _params_to_matrix(theta: jnp.ndarray) -> jnp.ndarray:
    a, b, tx, ty = theta[0], theta[1], theta[2], theta[3]
    return jnp.stack([jnp.stack([a, -b, tx]), jnp.stack([b, a, ty])])


@functools.partial(jax.jit, static_argnames=("n_hypotheses",))
def estimate_similarity_ransac(
    prev: jnp.ndarray, curr: jnp.ndarray, mask: jnp.ndarray,
    key: jax.Array, threshold: float = 5.0, n_hypotheses: int = 500,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """RANSAC 4-DOF similarity estimate (estimateAffinePartial2D semantics).

    Args:
      prev/curr: (N, 2) float32 point sets, (x, y).
      mask: (N,) bool validity.
      key: PRNG key (derive per frame from a stream seed + frame counter so
           the whole step stays a pure function).

    Returns:
      m: (2, 3) float32 transform (identity when under 4 valid points, matching
         Stabilizer.cpp:561-576's fallback).
      ok: scalar bool — estimate valid.
      inliers: (N,) bool inlier mask of the final model.
    """
    n = prev.shape[0]
    n_valid = jnp.sum(mask.astype(jnp.int32))

    # Compact valid indices to the front so uniform sampling hits valid points.
    order = jnp.argsort(~mask, stable=True)
    u = jax.random.randint(key, (n_hypotheses, 2), 0, jnp.maximum(n_valid, 1))
    samples = order[u]  # (K, 2) indices into point arrays

    def eval_hyp(pair):
        i, j = pair[0], pair[1]
        theta, ok = _similarity_from_two(prev[i], prev[j], curr[i], curr[j])
        ok = ok & (i != j)
        px, py = prev[:, 0], prev[:, 1]
        rx = theta[0] * px - theta[1] * py + theta[2]
        ry = theta[1] * px + theta[0] * py + theta[3]
        err2 = (rx - curr[:, 0]) ** 2 + (ry - curr[:, 1]) ** 2
        inl = mask & (err2 < threshold * threshold)
        score = jnp.where(ok, jnp.sum(inl.astype(jnp.int32)), -1)
        return score, inl

    scores, inlier_sets = jax.vmap(eval_hyp)(samples)
    best = jnp.argmax(scores)
    best_inliers = inlier_sets[best]

    theta, fit_ok = _similarity_lsq(prev, curr, best_inliers.astype(jnp.float32))
    enough = (n_valid >= 4) & (scores[best] >= 2) & fit_ok
    m = jnp.where(enough, _params_to_matrix(theta),
                  jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], jnp.float32))
    return m, enough, best_inliers & enough


@jax.jit
def estimate_rigid_closed_form(prev: jnp.ndarray, curr: jnp.ndarray,
                               mask: jnp.ndarray) -> jnp.ndarray:
    """Legacy closed-form rigid solve (Stabilizer_legacy.cpp:323-358):
    centroid translation + atan2(sum cross, sum dot) rotation.

    Returns (dx, dy, da); zeros when under 3 valid points.
    """
    w = mask.astype(jnp.float32)
    n = jnp.sum(w)
    ok = n >= 3.0
    safe_n = jnp.where(n > 0, n, 1.0)
    pm = jnp.sum(prev * w[:, None], axis=0) / safe_n
    qm = jnp.sum(curr * w[:, None], axis=0) / safe_n
    dx = qm[0] - pm[0]
    dy = qm[1] - pm[1]
    pc = prev - pm
    qc = curr - qm
    num = jnp.sum(w * (pc[:, 0] * qc[:, 1] - pc[:, 1] * qc[:, 0]))
    den = jnp.sum(w * (pc[:, 0] * qc[:, 0] + pc[:, 1] * qc[:, 1]))
    da = jnp.where(jnp.abs(den) > 1e-6, jnp.arctan2(num, den), 0.0)
    out = jnp.stack([dx, dy, da])
    return jnp.where(ok, out, jnp.zeros(3, jnp.float32))


def _masked_median_upper(vals: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """C++ nth_element median: sorted[n_valid // 2] (upper-mid for even n),
    matching Stabilizer_legacy.cpp:301-304."""
    big = jnp.where(mask, vals, jnp.inf)
    s = jnp.sort(big)
    n_valid = jnp.sum(mask.astype(jnp.int32))
    idx = jnp.clip(n_valid // 2, 0, vals.shape[0] - 1)
    return s[idx]


@jax.jit
def remove_outliers_median(prev: jnp.ndarray, curr: jnp.ndarray,
                           mask: jnp.ndarray, threshold: float = 15.0,
                           min_keep: int = 10) -> jnp.ndarray:
    """Legacy median-motion outlier rejection (Stabilizer_legacy.cpp:283-321).

    Returns the refined validity mask. If fewer than ``min_keep`` points
    survive, the original mask is kept (legacy:317).
    """
    motions = curr - prev
    med_x = _masked_median_upper(motions[:, 0], mask)
    med_y = _masked_median_upper(motions[:, 1], mask)
    dist = jnp.sqrt((motions[:, 0] - med_x) ** 2 + (motions[:, 1] - med_y) ** 2)
    kept = mask & (dist <= threshold)
    n_kept = jnp.sum(kept.astype(jnp.int32))
    return jnp.where(n_kept >= min_keep, kept, mask)
