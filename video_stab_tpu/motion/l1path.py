"""L1-optimal camera path smoothing (offline).

The cinematography-grade smoother from "Auto-Directed Video Stabilization
with Robust L1 Optimal Camera Paths" (Grundmann et al.) as revisited by
"Cinematic-L1 Video Stabilization with a Log-Homography Model"
(arxiv.org/pdf/2011.08144 — see PAPERS.md): minimize the L1 norms of the
path's first/second/third differences so the smoothed camera path is
piecewise constant / linear / parabolic (static shot -> pan -> ease-in/out),
subject to the smoothed path staying within a crop box of the original.

The reference library has nothing like this (its best is a gaussian filter);
it is the main quality gap between "smoothed" and "cinematic" output.

Solved with static shapes: ADMM with split variables z_k = D_k p, the p-update's
SPD system (I + rho * sum D_k^T D_k) p = rhs solved matrix-free by a fixed
CG iteration — everything is jnp ops with static iteration counts, so the
whole solver jit-compiles (no LP solver needed).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Weights from the L1 stabilization literature (w1:w2:w3 = 10:1:100).
W1, W2, W3 = 10.0, 1.0, 100.0


def _d1(p):
    return p[1:] - p[:-1]


def _d1t(z, n):
    out = jnp.zeros((n,) + z.shape[1:], z.dtype)
    out = out.at[:-1].add(-z)
    out = out.at[1:].add(z)
    return out


def _d2(p):
    return p[2:] - 2.0 * p[1:-1] + p[:-2]


def _d2t(z, n):
    out = jnp.zeros((n,) + z.shape[1:], z.dtype)
    out = out.at[:-2].add(z)
    out = out.at[1:-1].add(-2.0 * z)
    out = out.at[2:].add(z)
    return out


def _d3(p):
    return p[3:] - 3.0 * p[2:-1] + 3.0 * p[1:-2] - p[:-3]


def _d3t(z, n):
    out = jnp.zeros((n,) + z.shape[1:], z.dtype)
    out = out.at[:-3].add(-z)
    out = out.at[1:-2].add(3.0 * z)
    out = out.at[2:-1].add(-3.0 * z)
    out = out.at[3:].add(z)
    return out


def _soft(x, t):
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - t, 0.0)


@functools.partial(jax.jit, static_argnames=("n_admm", "n_cg"))
def l1_smooth_path(path: jnp.ndarray, bound: jnp.ndarray | float = 20.0,
                   rho: float = 1.0, n_admm: int = 60, n_cg: int = 25,
                   ) -> jnp.ndarray:
    """Smooth a (T, C) camera path with L1-optimal differences.

    Args:
      path: (T, C) cumulative trajectory (C = 3 for dx, dy, da).
      bound: scalar or (C,) box constraint |smoothed - path| <= bound
             (the crop margin in pixels / radians).

    Returns: (T, C) smoothed path.
    """
    n = path.shape[0]
    bound = jnp.broadcast_to(jnp.asarray(bound, path.dtype), path.shape[1:])

    def a_op(p):
        """(I + rho * (D1'D1 + D2'D2 + D3'D3)) p, matrix-free."""
        out = p
        out = out + rho * _d1t(_d1(p), n)
        out = out + rho * _d2t(_d2(p), n)
        out = out + rho * _d3t(_d3(p), n)
        return out

    def cg_solve(b, x0):
        r = b - a_op(x0)
        d = r
        rs = jnp.sum(r * r)

        def body(_, carry):
            x, r, d, rs = carry
            ad = a_op(d)
            alpha = rs / jnp.maximum(jnp.sum(d * ad), 1e-12)
            x = x + alpha * d
            r = r - alpha * ad
            rs_new = jnp.sum(r * r)
            d = r + (rs_new / jnp.maximum(rs, 1e-12)) * d
            return x, r, d, rs_new

        x, _, _, _ = jax.lax.fori_loop(0, n_cg, body, (x0, r, d, rs))
        return x

    def admm_body(_, carry):
        p, z1, z2, z3, u1, u2, u3 = carry
        # p-update: argmin ||p - path||^2/2? — fidelity is the box
        # projection below; the quadratic ties p to the consensus terms.
        rhs = path + rho * (_d1t(z1 - u1, n) + _d2t(z2 - u2, n) +
                            _d3t(z3 - u3, n))
        p = cg_solve(rhs, p)
        p = jnp.clip(p, path - bound, path + bound)   # crop-box constraint
        # z-updates: soft-threshold each difference order.
        z1 = _soft(_d1(p) + u1, W1 / rho)
        z2 = _soft(_d2(p) + u2, W2 / rho)
        z3 = _soft(_d3(p) + u3, W3 / rho)
        u1 = u1 + _d1(p) - z1
        u2 = u2 + _d2(p) - z2
        u3 = u3 + _d3(p) - z3
        return p, z1, z2, z3, u1, u2, u3

    p0 = path
    init = (p0, _d1(p0), _d2(p0), _d3(p0),
            jnp.zeros_like(_d1(p0)), jnp.zeros_like(_d2(p0)),
            jnp.zeros_like(_d3(p0)))
    p, *_ = jax.lax.fori_loop(0, n_admm, admm_body, init)
    return p
