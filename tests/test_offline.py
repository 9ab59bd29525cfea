"""Offline (batch) stabilization tests."""

import cv2
import numpy as np
import pytest

from video_stab_tpu.core.params import StabilizerParams
from video_stab_tpu.offline import stabilize_clip

SMALL = dict(analysis_width=96, analysis_height=64, max_corners=32,
             ransac_hypotheses=32)


def _clip(n=16, seed=0):
    rng = np.random.default_rng(seed)
    world = (cv2.GaussianBlur(
        rng.random((160, 220)).astype(np.float32), (0, 0), 2) * 255)
    frames = []
    for _ in range(n):
        dx, dy = rng.normal(0, 2, 2)
        m = np.float32([[1, 0, -(30 + dx)], [0, 1, -(30 + dy)]])
        f = cv2.warpAffine(world, m, (96, 64))
        frames.append(np.repeat(f[:, :, None], 3, 2).astype(np.uint8))
    return np.stack(frames)


def _jitter(frames):
    d = [np.abs(a[8:-8, 8:-8].astype(np.float32) -
                b[8:-8, 8:-8].astype(np.float32)).mean()
         for a, b in zip(frames[:-1], frames[1:])]
    return float(np.mean(d))


class TestOffline:
    @pytest.mark.parametrize("method,factor", [("box", 0.3),
                                               ("gaussian", 0.3),
                                               ("kalman", 0.7),
                                               ("butterworth", 0.7),
                                               ("l1", 0.2)])
    def test_reduces_jitter(self, method, factor):
        clip = _clip()
        p = StabilizerParams(smoothing_radius=6, smoothing_method=method,
                             **SMALL)
        out = stabilize_clip(clip, p)
        assert out.shape == clip.shape and out.dtype == np.uint8
        assert _jitter(out) < _jitter(clip) * factor

    def test_border_and_crop(self):
        clip = _clip(n=10)
        p = StabilizerParams(smoothing_radius=5, border_size=8, **SMALL)
        out = stabilize_clip(clip, p)
        assert out.shape == (10, 64 + 16, 96 + 16, 3)
        p = StabilizerParams(smoothing_radius=5, border_size=8,
                             crop_n_zoom=True, **SMALL)
        out = stabilize_clip(clip, p)
        assert out.shape == clip.shape

    def test_full_res_corrections_at_reduced_analysis(self):
        """With analysis at half the frame resolution, the applied
        translation correction must be rescaled to frame pixels
        (full_res_corrections=True, the default) — the reference applies
        analysis-space dx/dy unscaled (Stabilizer.cpp:901-907) and retains
        half the translational shake; False reproduces that quirk."""
        rng = np.random.default_rng(5)
        world = (cv2.GaussianBlur(
            rng.random((320, 440)).astype(np.float32), (0, 0), 2) * 255)
        frames = []
        for _ in range(14):
            dx, dy = rng.normal(0, 4, 2)
            m = np.float32([[1, 0, -(60 + dx)], [0, 1, -(60 + dy)]])
            f = cv2.warpAffine(world, m, (192, 128))
            frames.append(np.repeat(f[:, :, None], 3, 2).astype(np.uint8))
        clip = np.stack(frames)
        kw = dict(smoothing_radius=6, analysis_width=96, analysis_height=64,
                  max_corners=32, ransac_hypotheses=32)
        full = stabilize_clip(clip, StabilizerParams(**kw))
        quirk = stabilize_clip(
            clip, StabilizerParams(full_res_corrections=False, **kw))
        assert _jitter(full) < _jitter(clip) * 0.35
        # The unscaled path corrects only ~half the displacement.
        assert _jitter(full) < _jitter(quirk) * 0.8

    def test_non_chunk_multiple_length(self):
        clip = _clip(n=11)       # not a multiple of WARP_CHUNK
        p = StabilizerParams(smoothing_radius=5, **SMALL)
        out = stabilize_clip(clip, p)
        assert out.shape[0] == 11


class TestL1Path:
    def test_piecewise_linear_recovery(self):
        import jax.numpy as jnp
        from video_stab_tpu.motion import l1_smooth_path
        rng = np.random.default_rng(0)
        t = np.arange(120)
        base = np.where(t < 60, 0.0, (t - 60) * 0.5)   # static, then pan
        noisy = base + rng.normal(0, 2.0, 120)
        p = jnp.asarray(np.stack([noisy] * 3, 1).astype(np.float32))
        sm = np.asarray(l1_smooth_path(p, bound=jnp.asarray([8.0, 8.0, 8.0])))
        # jitter removed...
        assert np.abs(np.diff(sm[:, 0])).mean() < \
            np.abs(np.diff(noisy)).mean() * 0.25
        # ...within the crop-box constraint...
        assert np.abs(sm[:, 0] - noisy).max() <= 8.0 + 1e-3
        # ...and the static segment is near-constant
        assert sm[:55, 0].std() < noisy[:55].std() * 0.5


class TestHomographyPath:
    def test_ransac_recovers_known_homography(self):
        import jax
        from video_stab_tpu.motion import estimate_homography_ransac
        H = np.float32([[1.02, 0.01, 2.0], [0.005, 0.99, -1.5],
                        [1e-4, -5e-5, 1.0]])
        rng = np.random.default_rng(1)
        prev = (rng.random((80, 2)) * [600, 400]).astype(np.float32)
        d = H[2, 0] * prev[:, 0] + H[2, 1] * prev[:, 1] + H[2, 2]
        curr = np.stack(
            [(H[0, 0] * prev[:, 0] + H[0, 1] * prev[:, 1] + H[0, 2]) / d,
             (H[1, 0] * prev[:, 0] + H[1, 1] * prev[:, 1] + H[1, 2]) / d],
            1).astype(np.float32)
        bad = rng.choice(80, 20, replace=False)
        curr[bad] += rng.normal(0, 30, (20, 2)).astype(np.float32)
        Hm, ok, inl = estimate_homography_ransac(
            prev, curr, np.ones(80, bool), jax.random.PRNGKey(0),
            n_hypotheses=256)
        Hm = np.asarray(Hm)
        assert bool(ok)
        assert np.asarray(inl).sum() == 60       # exactly the clean points
        assert np.abs(Hm / Hm[2, 2] - H).max() < 1e-3

    def test_log_exp_roundtrip(self):
        import jax.numpy as jnp
        from video_stab_tpu.motion import exp_homography, log_homography
        H = jnp.asarray([[1.02, 0.01, 2.0], [0.005, 0.99, -1.5],
                         [1e-4, -5e-5, 1.0]], jnp.float32)
        back = np.asarray(exp_homography(log_homography(H)))
        Hn = np.asarray(H) / np.cbrt(np.linalg.det(np.asarray(H)))
        assert np.allclose(back, Hn, atol=1e-5)

    def test_warp_perspective_matches_cv2(self):
        from video_stab_tpu.ops import warp_perspective
        img = (np.random.default_rng(0).random((40, 60)).astype(np.float32)
               * 255)
        H = np.float32([[1.02, 0.01, 2.0], [0.005, 0.99, -1.5],
                        [1e-4, -5e-5, 1.0]])
        ours = np.asarray(warp_perspective(img, H))
        ref = cv2.warpPerspective(img, H, (60, 40))
        assert np.percentile(np.abs(ours - ref)[2:-2, 2:-2], 99) < 0.5

    def test_homography_mode_reduces_perspective_jitter(self):
        rng = np.random.default_rng(5)
        world = (cv2.GaussianBlur(
            rng.random((200, 260)).astype(np.float32), (0, 0), 2) * 255)
        frames = []
        for _ in range(14):
            dx, dy = rng.normal(0, 2, 2)
            p1, p2 = rng.normal(0, 2e-4, 2)
            Hf = np.float32([[1, 0, -(40 + dx)], [0, 1, -(40 + dy)],
                             [p1, p2, 1.0]])
            f = cv2.warpPerspective(world, Hf, (96, 64))
            frames.append(np.repeat(f[:, :, None], 3, 2).astype(np.uint8))
        clip = np.stack(frames)
        p = StabilizerParams(smoothing_radius=6, motion_model="homography",
                             ransac_hypotheses=128, analysis_width=96,
                             analysis_height=64, max_corners=48)
        out = stabilize_clip(clip, p)
        assert out.shape == clip.shape
        assert _jitter(out) < _jitter(clip) * 0.6


class TestBoxSmoother:
    """The offline box smoother (offline.box_filter_centered) and the plain
    oracle of the reference's CUDA kernel (box_filter_convolve_reference,
    src/stabilizer_cuda.cu:7-67)."""

    def test_oracle_matches_cuda_kernel_layout(self):
        # Hand-check the window convention on a tiny case vs the reference
        # kernel math (stabilizer_cuda.cu:7-16): out[i] = mean of
        # padded[i..i+r-1] with r median samples prepended.
        import jax.numpy as jnp

        from video_stab_tpu.offline import box_filter_convolve_reference
        path = jnp.asarray([1.0, 2.0, 3.0, 4.0], jnp.float32)
        r = 2
        med = 3.0  # upper median of [1,2,3,4]
        padded = [med, med, 1.0, 2.0, 3.0, 4.0]
        expect = [(padded[i] + padded[i + 1]) / 2 for i in range(4)]
        got = np.asarray(box_filter_convolve_reference(path, r))
        assert np.allclose(got, expect)

    @pytest.mark.parametrize("r", [1, 5, 16, 50])
    def test_centered_interior_matches_kernel_oracle(self, r):
        """Interior i in [r, n-r-2]: the centered window [i-r, i+r] is the
        kernel's trailing window of width 2r+1 ending at i+r."""
        import jax.numpy as jnp

        from video_stab_tpu.offline import (box_filter_centered,
                                            box_filter_convolve_reference)
        rng = np.random.default_rng(r)
        path = jnp.asarray(rng.normal(0, 5, (300, 3)).astype(np.float32))
        got = np.asarray(box_filter_centered(path, r))
        ref = np.asarray(box_filter_convolve_reference(path, 2 * r + 1))
        n = path.shape[0]
        np.testing.assert_allclose(got[r:n - r - 1], ref[2 * r + 1:n],
                                   atol=1e-4)

    def test_centered_edges_clamp_and_renormalize(self):
        import jax.numpy as jnp

        from video_stab_tpu.offline import box_filter_centered
        path = np.arange(10, dtype=np.float32)[:, None] ** 2
        got = np.asarray(box_filter_centered(jnp.asarray(path), 3))[:, 0]
        expect = [path[max(0, i - 3):i + 4, 0].mean() for i in range(10)]
        np.testing.assert_allclose(got, expect, rtol=1e-6)
        # Identity when the path is no longer than the radius.
        short = jnp.asarray(path[:3])
        np.testing.assert_array_equal(
            np.asarray(box_filter_centered(short, 3)), path[:3])

    def test_stabilize_clip_box_uses_centered_smoother(self):
        """The box method's corrections are raw + centered-mean(path) -
        path: a clip whose analysis motion is a pure ramp (constant pan)
        leaves its interior untouched."""
        import jax.numpy as jnp

        from video_stab_tpu.offline import _smooth_path
        params = StabilizerParams(smoothing_method="box", smoothing_radius=4)
        ramp = jnp.asarray(np.stack([np.arange(40.0)] * 3, axis=1),
                           jnp.float32)
        sm = np.asarray(_smooth_path(params, ramp))
        np.testing.assert_allclose(sm[4:-4], np.asarray(ramp)[4:-4],
                                   atol=1e-4)
