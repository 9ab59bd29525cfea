"""Device guard and import hygiene of the entry points that run on the
card (chip_smoke.py, bench.py, vstab)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=ROOT, **kw)
    env.pop("XLA_FLAGS", None)
    return env


class TestRequireGpu:
    def test_requested_cpu_is_honoured(self, monkeypatch):
        from video_stab_tpu.utils.device import require_gpu

        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        assert require_gpu().platform == "cpu"

    def test_unrequested_cpu_is_refused(self, monkeypatch):
        """A CPU backend that nobody asked for is a silent fallback."""
        from video_stab_tpu.utils.device import require_gpu

        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
        with pytest.raises(RuntimeError, match="no GPU backend"):
            require_gpu()

    def test_chip_smoke_refuses_cpu_even_when_requested(self, monkeypatch):
        sys.path.insert(0, ROOT)
        try:
            import chip_smoke
        finally:
            sys.path.remove(ROOT)
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        with pytest.raises(RuntimeError, match="no GPU backend"):
            chip_smoke.require_gpu()


def test_chip_smoke_exits_nonzero_on_cpu():
    """JAX_PLATFORMS=cpu: non-zero exit, and no result line."""
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       env=_env(JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU backend" in r.stderr


def test_bench_exits_nonzero_without_gpu():
    """No GPU and no explicit CPU request: bench.py refuses to measure."""
    env = _env()
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, sys; jax.config.update('jax_platforms', 'cpu');"
         "import bench; sys.exit(bench.main(['--config', '1080']))"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode != 0
    assert "no GPU backend" in r.stderr


@pytest.mark.parametrize("module", [
    "video_stab_tpu.core.chain",
    "video_stab_tpu.parallel",
    "video_stab_tpu.offline",
    "video_stab_tpu.io.runner",
    "chip_smoke",
])
def test_main_path_imports_no_optional_libraries(module):
    """The card's machine has numpy, scipy and JAX but not necessarily
    OpenCV, PyYAML or Flax: the main path must not import them."""
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "print(sorted(m for m in ('cv2', 'yaml', 'flax') "
            "if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=_env(JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout
