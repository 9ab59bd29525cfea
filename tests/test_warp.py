"""The emit warps (ops/warp.warp_affine_fast / warp_perspective_fast): u8
in, u8-valued f32 out, against cv2 goldens and the f32 gather reference."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_stab_tpu.ops.warp import (
    BORDER_CONSTANT,
    BORDER_REFLECT,
    BORDER_REFLECT_101,
    BORDER_REPLICATE,
    BORDER_WRAP,
    warp_affine,
    warp_affine_fast,
    warp_perspective,
    warp_perspective_fast,
)


def _img(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, shape, dtype=np.uint8)


def _rot(ang_deg, tx=0.0, ty=0.0, cx=0.0, cy=0.0):
    """Rotation by ang_deg about (cx, cy), then a (tx, ty) shift."""
    a = np.radians(ang_deg)
    c, s = np.cos(a), np.sin(a)
    return np.float32([[c, -s, (1 - c) * cx + s * cy + tx],
                       [s, c, -s * cx + (1 - c) * cy + ty]])


def _ref_u8(ref):
    return np.clip(np.round(ref), 0, 255).astype(np.int64)


def _check_vs_gather(out, ref, tie_band=1e-3):
    """Exact except where the f32 value sits within accumulation noise of
    a .5 rounding boundary; there at most one count."""
    out = np.asarray(out).astype(np.int64)
    ref = np.asarray(ref)
    d = np.abs(out - _ref_u8(ref))
    near_tie = np.abs(ref - np.floor(ref) - 0.5) < tie_band
    assert d[~near_tie].max(initial=0) == 0, d[~near_tie].max()
    assert d.max(initial=0) <= 1, d.max()


class TestAffineFast:
    def test_output_is_u8_valued_f32(self):
        img = _img((24, 40, 3), 0)
        out = warp_affine_fast(jnp.asarray(img), jnp.asarray(_rot(2.0, 1.5)))
        assert out.dtype == jnp.float32 and out.shape == img.shape
        o = np.asarray(out)
        assert o.min() >= 0 and o.max() <= 255
        assert np.array_equal(o, np.round(o))

    def test_identity_roundtrip(self):
        img = _img((16, 130, 3), 1)
        out = warp_affine_fast(jnp.asarray(img), jnp.asarray(_rot(0.0)))
        np.testing.assert_array_equal(np.asarray(out), img)

    @pytest.mark.parametrize("shape,ang,tx,ty", [
        ((24, 40, 3), 2.3, 3.3, -2.2),
        ((27, 133, 3), -1.7, -5.0, 4.5),
        ((33, 65), 0.8, 0.25, 0.75),
    ])
    def test_matches_gather_reference_on_odd_shapes(self, shape, ang, tx, ty):
        img = _img(shape, 2)
        m = jnp.asarray(_rot(ang, tx, ty))
        ref = warp_affine(jnp.asarray(img).astype(jnp.float32), m)
        _check_vs_gather(warp_affine_fast(jnp.asarray(img), m), ref)

    def test_float_input_is_quantized_first(self):
        """A float frame is rounded to u8 before the warp (CV_8U input)."""
        img = _img((20, 36, 3), 3).astype(np.float32) + 0.4
        m = jnp.asarray(_rot(1.0, 0.5))
        a = warp_affine_fast(jnp.asarray(img), m)
        b = warp_affine_fast(jnp.asarray(np.round(img).astype(np.uint8)), m)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_wide_rotation_edge_rows(self):
        """A 10-deg rotation about the centre of a wide frame (the fused
        roll regime): edge rows must be sampled, not blacked out."""
        h, w = 96, 640
        img = _img((h, w, 3), 5)
        m = jnp.asarray(_rot(10.0, cx=w / 2.0, cy=h / 2.0))
        ref = np.asarray(warp_affine(jnp.asarray(img).astype(jnp.float32), m))
        out = np.asarray(warp_affine_fast(jnp.asarray(img), m))
        _check_vs_gather(out, ref)
        assert not np.any((out == 0) & (_ref_u8(ref) > 64))

    def test_half_even_tie_rounding(self):
        """+0.5 px on alternating 0/1 columns gives exact .5 ties: round
        half to even (jnp.round), so interior ties land on 0."""
        img = np.zeros((16, 130), np.uint8)
        img[:, 1::2] = 1
        m = jnp.asarray(np.float32([[1, 0, 0.5], [0, 1, 0]]))
        out = np.asarray(warp_affine_fast(jnp.asarray(img), m))
        assert (out[:, 2:-2] == 0).all(), np.unique(out[:, 2:-2])

    def test_vmapped_per_stream_maps(self):
        """Batched streams with different corrections each get their own
        exact warp (the multi-stream emit vmaps this)."""
        imgs = np.stack([_img((40, 140, 3), 11), _img((40, 140, 3), 12)])
        ms = jnp.asarray(np.stack([_rot(0.05, 1.3, -0.7),
                                   _rot(5.2, 1.3, -0.7)]))
        outs = jax.vmap(warp_affine_fast)(jnp.asarray(imgs), ms)
        for i in range(2):
            ref = warp_affine(jnp.asarray(imgs[i]).astype(jnp.float32), ms[i])
            _check_vs_gather(outs[i], ref)

    @pytest.mark.parametrize("ang", [0.7, 4.0, 12.0])
    def test_cv2_golden(self, ang):
        img = _img((48, 80, 3), 7)
        m = _rot(ang, 2.5, -1.25, cx=40.0, cy=24.0)
        got = np.asarray(warp_affine_fast(jnp.asarray(img), jnp.asarray(m)))
        gold = cv2.warpAffine(img, m, (80, 48), flags=cv2.INTER_LINEAR)
        # cv2 quantizes its bilinear weights to 1/32; off by <= 1 count,
        # and the rim blends the constant border differently.
        d = np.abs(got - gold.astype(np.float32))[2:-2, 2:-2]
        assert d.max() <= 1.0, d.max()

    @pytest.mark.parametrize("mode,cv_mode", [
        (BORDER_CONSTANT, cv2.BORDER_CONSTANT),
        (BORDER_REPLICATE, cv2.BORDER_REPLICATE),
        (BORDER_REFLECT, cv2.BORDER_REFLECT),
        (BORDER_REFLECT_101, cv2.BORDER_REFLECT_101),
        (BORDER_WRAP, cv2.BORDER_WRAP),
    ])
    def test_border_modes_vs_cv2(self, mode, cv_mode):
        img = _img((32, 48, 3), 9)
        m = _rot(6.0, 5.5, -4.25, cx=24.0, cy=16.0)
        got = np.asarray(warp_affine_fast(jnp.asarray(img), jnp.asarray(m),
                                          border_mode=mode))
        gold = cv2.warpAffine(img, m, (48, 32), flags=cv2.INTER_LINEAR,
                              borderMode=cv_mode).astype(np.float32)
        d = np.abs(got - gold)
        # Bilinear weight quantization: <= 1 count almost everywhere; at
        # the exact border seam cv2 may take the other neighbour.
        assert np.mean(d <= 1.0) > 0.995, np.mean(d <= 1.0)


class TestPerspectiveFast:
    @pytest.mark.parametrize("ang,px,py,seed", [
        (0.4, 3e-5, -2e-5, 6),       # small near-identity correction
        (4.0, 6e-5, 4e-5, 9),        # large
    ])
    def test_matches_gather_reference(self, ang, px, py, seed):
        a = np.radians(ang)
        hm = np.float32([[np.cos(a), -np.sin(a), 2.1],
                         [np.sin(a), np.cos(a), -1.3],
                         [px, py, 1.0]])
        img = _img((40, 140, 3), seed)
        ref = warp_perspective(jnp.asarray(img).astype(jnp.float32),
                               jnp.asarray(hm))
        out = warp_perspective_fast(jnp.asarray(img), jnp.asarray(hm))
        _check_vs_gather(out, ref)

    def test_identity_exact(self):
        img = _img((24, 132, 3), 2)
        out = warp_perspective_fast(jnp.asarray(img), jnp.eye(3))
        np.testing.assert_array_equal(np.asarray(out), img)

    @pytest.mark.parametrize("px", [2e-4, 1e-3])
    def test_cv2_golden(self, px):
        img = _img((48, 80, 3), 4)
        hm = np.float32([[1.01, -0.02, 1.5], [0.015, 0.99, -2.0],
                         [px, -px / 2, 1.0]])
        got = np.asarray(warp_perspective_fast(jnp.asarray(img),
                                               jnp.asarray(hm)))
        gold = cv2.warpPerspective(img, hm, (80, 48),
                                   flags=cv2.INTER_LINEAR).astype(np.float32)
        d = np.abs(got - gold)[2:-2, 2:-2]
        assert np.mean(d <= 1.0) > 0.995, np.mean(d <= 1.0)
