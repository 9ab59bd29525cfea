"""Affine warping and remapping with OpenCV border-mode semantics.

Counterpart of the reference's warp call sites:
cv::warpAffine / cv::cuda::warpAffine (src/Stabilizer.cpp:1024-1060,
src/Stabilizer_legacy.cpp:477-498, src/AutoZoomCrop.cpp:270) and
cv::cuda::buildWarpAffineMaps + remap (src/RollCorrection.cpp:146-149).

``warp_affine(img, M)`` computes dst(x, y) = src(M^{-1} [x, y, 1]) with
bilinear sampling, matching cv2.warpAffine without WARP_INVERSE_MAP.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

BORDER_CONSTANT = 0
BORDER_REPLICATE = 1
BORDER_REFLECT = 2
BORDER_WRAP = 3
BORDER_REFLECT_101 = 4

_BORDER_NAMES = {
    "black": BORDER_CONSTANT,
    "constant": BORDER_CONSTANT,
    "replicate": BORDER_REPLICATE,
    "reflect": BORDER_REFLECT,
    "wrap": BORDER_WRAP,
    "reflect_101": BORDER_REFLECT_101,
    "reflect101": BORDER_REFLECT_101,
    "fade": BORDER_CONSTANT,  # fade = constant warp + host-side history blend
}


def border_mode_from_name(name: str) -> int:
    """Map the reference's borderType strings (Stabilizer.cpp:31-38) to codes."""
    return _BORDER_NAMES.get(name.lower(), BORDER_CONSTANT)


def _reflect_index(i: jnp.ndarray, n: int, include_edge: bool) -> jnp.ndarray:
    """Reflect out-of-range indices. include_edge=True -> BORDER_REFLECT
    (edge duplicated: -1 -> 0), False -> BORDER_REFLECT_101 (-1 -> 1)."""
    if n == 1:
        return jnp.zeros_like(i)
    if include_edge:
        period = 2 * n
        i = jnp.mod(i, period)
        return jnp.where(i >= n, period - 1 - i, i)
    period = 2 * (n - 1)
    i = jnp.mod(i, period)
    return jnp.where(i >= n, period - i, i)


def _map_index(i: jnp.ndarray, n: int, mode: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Map integer sample index to in-range index + validity (for CONSTANT)."""
    valid = (i >= 0) & (i <= n - 1)
    if mode == BORDER_CONSTANT:
        return jnp.clip(i, 0, n - 1), valid
    if mode == BORDER_REPLICATE:
        return jnp.clip(i, 0, n - 1), jnp.ones_like(valid)
    if mode == BORDER_REFLECT:
        return _reflect_index(i, n, include_edge=True), jnp.ones_like(valid)
    if mode == BORDER_REFLECT_101:
        return _reflect_index(i, n, include_edge=False), jnp.ones_like(valid)
    if mode == BORDER_WRAP:
        return jnp.mod(i, n), jnp.ones_like(valid)
    raise ValueError(f"unknown border mode {mode}")


def sample_bilinear(img: jnp.ndarray, xs: jnp.ndarray, ys: jnp.ndarray,
                    border_mode: int = BORDER_CONSTANT,
                    border_value: float = 0.0) -> jnp.ndarray:
    """Bilinear sample img (H, W) or (H, W, C) at float coords (xs, ys).

    xs/ys may have any (matching) shape; returns samples with that shape
    (plus trailing C if img has channels).
    """
    has_c = img.ndim == 3
    h, w = img.shape[:2]
    x0f = jnp.floor(xs)
    y0f = jnp.floor(ys)
    fx = (xs - x0f).astype(img.dtype if img.dtype == jnp.float32 else jnp.float32)
    fy = (ys - y0f).astype(fx.dtype)
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)

    def tap(yi, xi):
        ym, yv = _map_index(yi, h, border_mode)
        xm, xv = _map_index(xi, w, border_mode)
        v = img[ym, xm]
        ok = yv & xv
        if border_mode == BORDER_CONSTANT:
            if has_c:
                ok = ok[..., None]
            v = jnp.where(ok, v, border_value)
        return v

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    if has_c:
        fx = fx[..., None]
        fy = fy[..., None]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def invert_affine(m: jnp.ndarray) -> jnp.ndarray:
    """Invert a 2x3 affine matrix (cv::invertAffineTransform)."""
    a, b, tx = m[0, 0], m[0, 1], m[0, 2]
    c, d, ty = m[1, 0], m[1, 1], m[1, 2]
    det = a * d - b * c
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return jnp.stack([jnp.stack([ia, ib, itx]), jnp.stack([ic, id_, ity])])


def warp_affine(img: jnp.ndarray, m: jnp.ndarray,
                out_h: int | None = None, out_w: int | None = None,
                border_mode: int = BORDER_CONSTANT,
                border_value: float = 0.0,
                inverse_map: bool = False) -> jnp.ndarray:
    """cv2.warpAffine: dst(x,y) = src(M^{-1}(x,y)), bilinear.

    m: (2, 3) float affine (dst <- src forward map unless inverse_map).
    """
    out_h = out_h if out_h is not None else img.shape[0]
    out_w = out_w if out_w is not None else img.shape[1]
    minv = m if inverse_map else invert_affine(m)
    ys = jnp.arange(out_h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(out_w, dtype=jnp.float32)[None, :]
    sx = minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]
    sy = minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]
    sx = jnp.broadcast_to(sx, (out_h, out_w))
    sy = jnp.broadcast_to(sy, (out_h, out_w))
    return sample_bilinear(img, sx, sy, border_mode, border_value)


def _pad_mode(border_mode: int):
    return {BORDER_CONSTANT: "constant", BORDER_REPLICATE: "edge",
            BORDER_REFLECT: "symmetric", BORDER_REFLECT_101: "reflect",
            BORDER_WRAP: "wrap"}[border_mode]


def warp_affine_tiled(img: jnp.ndarray, m: jnp.ndarray,
                      out_h: int | None = None, out_w: int | None = None,
                      border_mode: int = BORDER_CONSTANT,
                      border_value: float = 0.0,
                      inverse_map: bool = False,
                      max_angle_deg: float = 6.0,
                      max_shift: int = 128) -> jnp.ndarray:
    """Exact-bilinear affine warp for near-rigid maps, XLA formulation.

    Same result as ``warp_affine`` (direct 2D bilinear, cv2 semantics) but
    built from dynamic slices + static shifted views instead of per-pixel
    gathers. No hot path uses it: inside the GPU chain step it lost to the
    u8 gather warp (``warp_affine_fast``; PERF.md). Per (8, 128) output tile the
    source footprint of an affine map is a slab of statically bounded size;
    one dynamic_slice fetches it, and exact bilinear reconstruction is a
    static sum over (ry, rx) integer offsets weighted by hat functions
    ``max(0, 1-|q-r|)`` — only the 4 taps with nonzero weight contribute,
    reproducing bilinear exactly.

    Static envelope: |rotation| <= max_angle_deg, |scale-1| small (the
    rotation budget doubles as the off-diagonal/row-scale budget), source
    translation anywhere within ``max_shift`` px of the output tile (plus
    out-of-image sampling up to max_shift, served by a pre-pad in the
    requested border mode). Outside the envelope the result degrades to
    ``border_value``-ish instead of being wrong-but-plausible; hot callers
    (stabilizer emit, roll correct, virtual canvas) have corrections far
    inside it. Reference call sites: src/Stabilizer.cpp:1024-1060,
    src/RollCorrection.cpp:146-149.
    """
    out_h = out_h if out_h is not None else img.shape[0]
    out_w = out_w if out_w is not None else img.shape[1]
    minv = m if inverse_map else invert_affine(m)
    minv = minv.astype(jnp.float32)
    a_, b_, c_ = minv[0, 0], minv[0, 1], minv[0, 2]
    d_, e_, f_ = minv[1, 0], minv[1, 1], minv[1, 2]

    has_c = img.ndim == 3
    if not has_c:
        img = img[:, :, None]
    ch = img.shape[2]
    th, tw = 8, 128
    s_max = abs(math.sin(math.radians(float(max_angle_deg))))
    # Shift-term counts from the static envelope (sin bounds the
    # off-diagonals; cos-1 ~ -s^2/2 bounds the diagonal deviation).
    ry_terms = int(np.ceil(s_max * (tw - 1) + (s_max ** 2) * th + 1)) + 2
    rx_terms = int(np.ceil(s_max * (th - 1) + (s_max ** 2) * tw + 1)) + 2
    sh, sw = th + ry_terms - 1, tw + rx_terms - 1

    # The tile grid overhangs out_h/out_w by up to a tile; those lanes are
    # cropped from the result but still sampled, so the pad covers
    # max_shift + one tile + the envelope's coordinate deviation over the
    # full frame (sin across the orthogonal extent + the cos-1 ~ s^2
    # diagonal term — at wide envelopes sin*dim reaches hundreds of px)
    # in each dimension (keeps every in-envelope slice clamp-free — the
    # base-offset/weight invariant depends on that).
    dev_y = int(np.ceil(s_max * (out_w + 2 * max_shift)
                        + (s_max ** 2) * (out_h + 2 * max_shift)))
    dev_x = int(np.ceil(s_max * (out_h + 2 * max_shift)
                        + (s_max ** 2) * (out_w + 2 * max_shift)))
    pad_y = max_shift + th + 2 + dev_y
    pad_x = max_shift + tw + 2 + dev_x
    widths = ((pad_y, pad_y), (pad_x, pad_x), (0, 0))
    if border_mode == BORDER_CONSTANT:
        imgp = jnp.pad(img, widths, constant_values=border_value)
    else:
        imgp = jnp.pad(img, widths, mode=_pad_mode(border_mode))

    nty = -(-out_h // th)
    ntx = -(-out_w // tw)

    dy = jnp.arange(th, dtype=jnp.float32)[:, None]
    dx = jnp.arange(tw, dtype=jnp.float32)[None, :]

    def do_tile(ty, tx):
        y0 = (ty * th).astype(jnp.float32)
        x0 = (tx * tw).astype(jnp.float32)
        # Source coords over the tile (exact, same math as warp_affine).
        sx = a_ * (x0 + dx) + b_ * (y0 + dy) + c_
        sy = d_ * (x0 + dx) + e_ * (y0 + dy) + f_
        # Base = floor of the min RESIDUAL (source minus local output
        # coordinate): the reconstruction indexes tile[dy + ry, dx + rx],
        # so the invariant is qy - dy ∈ [0, ry_terms), not qy ∈ [...].
        base_y = jnp.floor(jnp.min(sy - dy)).astype(jnp.int32)
        base_x = jnp.floor(jnp.min(sx - dx)).astype(jnp.int32)
        # Keep the slice inside the padded image: shifts beyond the static
        # envelope clamp (degraded, documented) instead of OOB.
        base_y = jnp.clip(base_y, -pad_y, img.shape[0] + pad_y - sh)
        base_x = jnp.clip(base_x, -pad_x, img.shape[1] + pad_x - sw)
        tile = jax.lax.dynamic_slice(
            imgp, (base_y + pad_y, base_x + pad_x, 0), (sh, sw, ch))
        qy = sy - base_y.astype(jnp.float32)
        qx = sx - base_x.astype(jnp.float32)
        wxs = [jnp.maximum(0.0, 1.0 - jnp.abs(qx - (dx + rx)))
               for rx in range(rx_terms)]
        out = jnp.zeros((th, tw, ch), jnp.float32)
        for ry in range(ry_terms):
            wy = jnp.maximum(0.0, 1.0 - jnp.abs(qy - (dy + ry)))
            inner = jnp.zeros((th, tw, ch), jnp.float32)
            for rx in range(rx_terms):
                inner = inner + wxs[rx][:, :, None] * \
                    jax.lax.dynamic_slice(tile, (ry, rx, 0), (th, tw, ch))
            out = out + wy[:, :, None] * inner
        return out

    tys = jnp.repeat(jnp.arange(nty), ntx)
    txs = jnp.tile(jnp.arange(ntx), nty)
    tiles = jax.vmap(do_tile)(tys, txs)          # (nty*ntx, th, tw, ch)
    full = tiles.reshape(nty, ntx, th, tw, ch).transpose(0, 2, 1, 3, 4)
    full = full.reshape(nty * th, ntx * tw, ch)[:out_h, :out_w]
    return full if has_c else full[:, :, 0]


def _to_u8(img: jnp.ndarray) -> jnp.ndarray:
    if img.dtype != jnp.uint8:
        img = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return img


def warp_affine_fast(img: jnp.ndarray, m: jnp.ndarray,
                     out_h: int | None = None, out_w: int | None = None,
                     border_mode: int = BORDER_CONSTANT,
                     border_value: float = 0.0) -> jnp.ndarray:
    """u8-domain affine warp for the hot per-frame paths.

    The gather ``warp_affine`` on the u8 frame: input and output are
    quantized to u8 — exactly the reference's CV_8U cv::warpAffine
    semantics (src/Stabilizer.cpp:1024-1060) — and the result is float32
    holding integers so downstream math is unchanged. Gathering u8 moves a
    quarter of the bytes of an f32 gather; XLA fuses the four taps, the
    weights and the rounding into one kernel. Exact for any map: there is
    no envelope to leave. Chosen over ``warp_affine_tiled`` by timing both
    inside the chain step on the GPU (PERF.md, bring-up findings).
    """
    out = warp_affine(_to_u8(img), m, out_h, out_w, border_mode,
                      border_value)
    return jnp.clip(jnp.round(out), 0, 255)


def warp_perspective_fast(img: jnp.ndarray, h_mat: jnp.ndarray,
                          out_h: int | None = None, out_w: int | None = None,
                          border_mode: int = BORDER_CONSTANT,
                          border_value: float = 0.0) -> jnp.ndarray:
    """u8-domain PROJECTIVE warp for the homography emit path: the gather
    ``warp_perspective`` on the u8 frame, quantized like
    ``warp_affine_fast`` (the reference pipeline is CV_8U end-to-end)."""
    out = warp_perspective(_to_u8(img), h_mat, out_h, out_w, border_mode,
                           border_value)
    return jnp.clip(jnp.round(out), 0, 255)


def remap_bilinear(img: jnp.ndarray, map_x: jnp.ndarray, map_y: jnp.ndarray,
                   border_mode: int = BORDER_REPLICATE,
                   border_value: float = 0.0) -> jnp.ndarray:
    """cv2.remap with bilinear interpolation (RollCorrection.cpp:148)."""
    return sample_bilinear(img, map_x, map_y, border_mode, border_value)


def warp_perspective(img: jnp.ndarray, h_mat: jnp.ndarray,
                     out_h: int | None = None, out_w: int | None = None,
                     border_mode: int = BORDER_CONSTANT,
                     border_value: float = 0.0,
                     inverse_map: bool = False) -> jnp.ndarray:
    """cv2.warpPerspective: dst(x,y) = src(H^{-1}(x,y)), bilinear.

    h_mat: (3, 3) homography (dst <- src forward map unless inverse_map).
    Reference counterpart: the homography serving config (BASELINE.json
    config 3); the reference itself is affine-only.
    """
    out_h = out_h if out_h is not None else img.shape[0]
    out_w = out_w if out_w is not None else img.shape[1]
    hinv = h_mat if inverse_map else jnp.linalg.inv(h_mat)
    ys = jnp.arange(out_h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(out_w, dtype=jnp.float32)[None, :]
    denom = hinv[2, 0] * xs + hinv[2, 1] * ys + hinv[2, 2]
    denom = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    sx = (hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]) / denom
    sy = (hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]) / denom
    sx = jnp.broadcast_to(sx, (out_h, out_w))
    sy = jnp.broadcast_to(sy, (out_h, out_w))
    return sample_bilinear(img, sx, sy, border_mode, border_value)


def rotation_matrix_2d(center_x, center_y, angle_deg, scale=1.0) -> jnp.ndarray:
    """cv2.getRotationMatrix2D: positive angle rotates CCW (y-down image coords).

    Reference use: RollCorrection.cpp:144.
    """
    a = jnp.deg2rad(angle_deg)
    alpha = scale * jnp.cos(a)
    beta = scale * jnp.sin(a)
    tx = (1.0 - alpha) * center_x - beta * center_y
    ty = beta * center_x + (1.0 - alpha) * center_y
    return jnp.stack([
        jnp.stack([alpha, beta, tx]),
        jnp.stack([-beta, alpha, ty]),
    ]).astype(jnp.float32)


def similarity_matrix(dx, dy, da, scale=1.0) -> jnp.ndarray:
    """The stabilizer's 2x3 rigid matrix (Stabilizer.cpp:902-908):
    [[cos da, -sin da, dx], [sin da, cos da, dy]]."""
    c = jnp.cos(da) * scale
    s = jnp.sin(da) * scale
    return jnp.stack([
        jnp.stack([c, -s, jnp.asarray(dx, jnp.float32) * 1.0]),
        jnp.stack([s, c, jnp.asarray(dy, jnp.float32) * 1.0]),
    ]).astype(jnp.float32)
