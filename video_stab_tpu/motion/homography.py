"""Homography estimation + log-homography trajectory smoothing.

The reference is affine-only (estimateAffinePartial2D); the 8-DOF path is
the serving config BASELINE.json names ("1080p homography path") and the
model of "Cinematic-L1 Video Stabilization with a Log-Homography Model"
(arxiv.org/pdf/2011.08144 — PAPERS.md): inter-frame homographies are mapped
into the Lie algebra sl(3) where they add, the accumulated log-path is
smoothed with any 1-D filter (including the L1-optimal one), and the
correcting warp is exp(smoothed - path).

All static-shape and jit-friendly: RANSAC evaluates all 4-point hypotheses
in parallel (batched 8x8 solves), the matrix log uses a Mercator
series (inter-frame homographies are near identity), and exp uses
jax.scipy.linalg.expm.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# f32 products at full f32 precision on every backend (DESIGN.md §2a).
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=_HIGHEST)


def conjugate(s: jnp.ndarray, h: jnp.ndarray, s_inv: jnp.ndarray
              ) -> jnp.ndarray:
    """S H S^-1: a homography moved into the coordinates S maps to."""
    return _mm(_mm(s, h), s_inv)


def _dlt_4pt(p: jnp.ndarray, q: jnp.ndarray):
    """Exact homography from 4 correspondences: solve the 8x8 DLT system.

    p, q: (4, 2). Returns (3,3) H with H[2,2]=1 and an ok flag.
    """
    rows = []
    for i in range(4):
        x, y = p[i, 0], p[i, 1]
        u, v = q[i, 0], q[i, 1]
        rows.append(jnp.stack([x, y, 1.0, jnp.zeros(()), jnp.zeros(()),
                               jnp.zeros(()), -u * x, -u * y]))
        rows.append(jnp.stack([jnp.zeros(()), jnp.zeros(()), jnp.zeros(()),
                               x, y, 1.0, -v * x, -v * y]))
    a = jnp.stack(rows)                        # (8, 8)
    b = jnp.stack([q[0, 0], q[0, 1], q[1, 0], q[1, 1],
                   q[2, 0], q[2, 1], q[3, 0], q[3, 1]])
    # ONE LU factorization serves both the degeneracy check (|det| =
    # |prod diag(U)|, the pivoted LU's determinant magnitude) and the
    # solve — the original det + solve pair ran two LU sweeps per
    # hypothesis x 500 (this sits on the streaming homography hot path).
    import jax.scipy.linalg as jsl
    lu, piv = jsl.lu_factor(a)
    absdet = jnp.abs(jnp.prod(jnp.diagonal(lu)))
    det_ok = (absdet > 1e-8) & jnp.all(jnp.isfinite(lu))
    h8 = jsl.lu_solve((jnp.where(jnp.isfinite(lu), lu, 0.0), piv), b)
    h8 = jnp.where(det_ok, h8, jnp.zeros(8))
    h = jnp.concatenate([h8, jnp.ones((1,))]).reshape(3, 3)
    return h, det_ok


def _project(h: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (3,3) H to (N,2) points."""
    x, y = pts[:, 0], pts[:, 1]
    d = h[2, 0] * x + h[2, 1] * y + h[2, 2]
    d = jnp.where(jnp.abs(d) < 1e-9, 1e-9, d)
    u = (h[0, 0] * x + h[0, 1] * y + h[0, 2]) / d
    v = (h[1, 0] * x + h[1, 1] * y + h[1, 2]) / d
    return jnp.stack([u, v], axis=1)


@functools.partial(jax.jit, static_argnames=("n_hypotheses",))
def estimate_homography_ransac(prev: jnp.ndarray, curr: jnp.ndarray,
                               mask: jnp.ndarray, key: jax.Array,
                               threshold: float = 5.0,
                               n_hypotheses: int = 500):
    """8-DOF RANSAC homography (cv::findHomography(RANSAC) semantics).

    prev/curr: (N, 2) masked point sets. Returns (H (3,3), ok, inliers).
    Identity when under 8 valid points.
    """
    n = prev.shape[0]
    n_valid = jnp.sum(mask.astype(jnp.int32))
    order = jnp.argsort(~mask, stable=True)
    u = jax.random.randint(key, (n_hypotheses, 4), 0,
                           jnp.maximum(n_valid, 1))
    samples = order[u]                          # (K, 4)

    def eval_hyp(idx):
        p = prev[idx]
        q = curr[idx]
        h, ok = _dlt_4pt(p, q)
        # distinct sample check
        distinct = (idx[0] != idx[1]) & (idx[0] != idx[2]) & \
            (idx[0] != idx[3]) & (idx[1] != idx[2]) & \
            (idx[1] != idx[3]) & (idx[2] != idx[3])
        proj = _project(h, prev)
        err2 = jnp.sum((proj - curr) ** 2, axis=1)
        inl = mask & (err2 < threshold * threshold)
        score = jnp.where(ok & distinct,
                          jnp.sum(inl.astype(jnp.int32)), -1)
        return score, inl

    scores, inlier_sets = jax.vmap(eval_hyp)(samples)
    best = jnp.argmax(scores)
    best_inl = inlier_sets[best]

    # Least-squares refit on the best inlier set: Hartley-normalized DLT
    # (similarity-normalize both point sets to mean 0 / RMS sqrt(2) for
    # conditioning) via the smallest singular vector of the weighted
    # 2N x 9 system, then denormalize.
    w = best_inl.astype(jnp.float32)
    n_w = jnp.maximum(jnp.sum(w), 1.0)

    def norm_transform(pts):
        mean = jnp.sum(pts * w[:, None], axis=0) / n_w
        d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=1))
        scale = jnp.sqrt(2.0) / jnp.maximum(
            jnp.sum(d * w) / n_w, 1e-6)
        t = jnp.asarray([[scale, 0.0, -scale * mean[0]],
                         [0.0, scale, -scale * mean[1]],
                         [0.0, 0.0, 1.0]])
        return t, (pts - mean) * scale

    t_p, pn = norm_transform(prev)
    t_q, qn = norm_transform(curr)
    x, y = pn[:, 0], pn[:, 1]
    uu, vv = qn[:, 0], qn[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([x, y, o, z, z, z, -uu * x, -uu * y, -uu], axis=1)
    r2 = jnp.stack([z, z, z, x, y, o, -vv * x, -vv * y, -vv], axis=1)
    a = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], axis=0)  # (2N,9)
    # Smallest right singular vector via eigh of the 9x9 normal matrix —
    # a (9,2N)@(2N,9) matmul + a tiny symmetric eigendecomposition,
    # instead of a full (2N,9) SVD on the streaming hot path. Hartley
    # normalization keeps A well enough conditioned that the squared
    # condition number is harmless here.
    ata = jnp.matmul(a.T, a, precision=_HIGHEST)
    _, vecs = jnp.linalg.eigh(ata)
    hn = vecs[:, 0].reshape(3, 3)             # smallest eigenvalue first
    h = _mm(_mm(jnp.linalg.inv(t_q), hn), t_p)
    h = h / jnp.where(jnp.abs(h[2, 2]) > 1e-9, h[2, 2], 1e-9)

    enough = (n_valid >= 8) & (scores[best] >= 4)
    h = jnp.where(enough, h, jnp.eye(3))
    return h, enough, best_inl & enough


def _normalize_sl3(h: jnp.ndarray) -> jnp.ndarray:
    """Scale H so det = 1 (SL(3) representative)."""
    det = jnp.linalg.det(h)
    s = jnp.sign(det) * jnp.abs(det) ** (1.0 / 3.0)
    return h / jnp.where(jnp.abs(s) > 1e-9, s, 1e-9)


def log_homography(h: jnp.ndarray, n_terms: int = 12) -> jnp.ndarray:
    """Matrix log of a near-identity homography via the Mercator series
    log(I+X) = X - X^2/2 + X^3/3 - ... (inter-frame warps are small)."""
    h = _normalize_sl3(h)
    x = h - jnp.eye(3)
    term = x
    out = jnp.zeros((3, 3))
    for k in range(1, n_terms + 1):
        out = out + ((-1.0) ** (k + 1)) / k * term
        term = _mm(term, x)
    return out


def exp_homography(l: jnp.ndarray) -> jnp.ndarray:
    """Matrix exponential sl(3) -> SL(3)."""
    import jax.scipy.linalg as jsl

    # expm's own products name no precision; pin them while tracing.
    with jax.default_matmul_precision("highest"):
        return jsl.expm(l)


def smooth_homography_path(logs: jnp.ndarray, smoother) -> jnp.ndarray:
    """logs: (T, 3, 3) per-frame log-homographies (forward motion
    convention). Returns (T, 3, 3) correcting homographies:
    exp(raw + smoothed_path - path) per frame, the log-space analog of the
    affine correction formula."""
    t = logs.shape[0]
    flat = logs.reshape(t, 9)
    path = jnp.cumsum(flat, axis=0)
    smoothed = smoother(path)
    corr = flat + (smoothed - path)
    return jax.vmap(exp_homography)(corr.reshape(t, 3, 3))
