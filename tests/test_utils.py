"""Utils tests: checkpointing, telemetry."""

import numpy as np

from video_stab_tpu.utils.checkpoint import load_state, save_state
from video_stab_tpu.utils.telemetry import FpsMeter, Metrics, StageTimer


class TestCheckpoint:
    def test_stabilizer_state_file_roundtrip(self, tmp_path, jittered_clip):
        from video_stab_tpu import Stabilizer, StabilizerParams
        frames, _ = jittered_clip
        p = StabilizerParams(smoothing_radius=6, analysis_width=128,
                             analysis_height=96, max_corners=64,
                             ransac_hypotheses=64)
        st = Stabilizer(p)
        for f in frames[:8]:
            st.stabilize(f)
        path = str(tmp_path / "stream.npz")
        save_state(st._state, path)
        a = st.stabilize(frames[8])

        from video_stab_tpu.core.state import stabilizer_state_init
        h, w = frames[0].shape[:2]
        template = stabilizer_state_init(p, h, w)
        st2 = Stabilizer(p)
        st2.load_state_dict(load_state(path, template), h, w)
        b = st2.stabilize(frames[8])
        assert np.array_equal(a, b)    # bit-exact resume

    def test_shape_mismatch_rejected(self, tmp_path):
        import jax.numpy as jnp
        path = str(tmp_path / "s.npz")
        save_state({"a": jnp.zeros((3, 3))}, path)
        try:
            load_state(path, {"a": jnp.zeros((4, 4))})
            assert False, "should have raised"
        except ValueError:
            pass


class TestTelemetry:
    def test_stage_timer_and_metrics(self):
        m = Metrics()
        with m.timer.stage("warp"):
            pass
        m.inc("frames_out", 3)
        m.set("inlier_ratio", 0.9)
        snap = m.snapshot()
        assert snap["counters"]["frames_out"] == 3
        assert snap["gauges"]["inlier_ratio"] == 0.9
        assert "warp" in snap["stages"]
        assert snap["stages"]["warp"]["n"] == 1

    def test_fps_meter(self):
        f = FpsMeter()
        assert f.tick() == 0.0
        assert f.tick() > 0.0


class TestCompilationCache:
    """utils/cache.enable_compilation_cache: JAX_COMPILATION_CACHE_DIR
    wins; otherwise a fixed absolute path inside the checkout."""

    def test_environment_variable_wins(self, monkeypatch, tmp_path):
        import jax

        from video_stab_tpu.utils import cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_absolute_and_fixed(self, monkeypatch, tmp_path):
        import os

        from video_stab_tpu.utils import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        first = cache.compilation_cache_dir()
        monkeypatch.chdir(tmp_path)
        assert cache.compilation_cache_dir() == first
        assert os.path.isabs(first)
        repo = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                            os.pardir))
        assert first == os.path.join(repo, ".jax_cache",
                                     "host-" + cache.host_fingerprint())

    def test_enable_sets_the_fixed_path(self, monkeypatch):
        import jax

        from video_stab_tpu.utils import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = cache.enable_compilation_cache()
            assert path == cache.compilation_cache_dir()
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
