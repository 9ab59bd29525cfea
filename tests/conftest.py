"""Test configuration: force JAX onto CPU (with 8 virtual devices for
sharding tests) BEFORE jax initializes, and keep OpenCV single-threaded
(cv2's thread pool can deadlock beside JAX's)."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Also through jax.config, in case a plugin imported jax before this file.
jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the variant-matrix tests recompile the same
# programs every run; caching them cuts suite wall-clock severalfold.
# JAX_COMPILATION_CACHE_DIR wins when set; otherwise the host-keyed
# directory inside the checkout (utils/cache.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from video_stab_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import cv2  # noqa: E402

cv2.setNumThreads(0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


_modules_since_clear = [0]


@pytest.fixture(autouse=True, scope="module")
def _bound_inprocess_accumulation():
    """Full-suite runs (~227 tests, ~1000 compiled executables in one
    process) crash with SIGSEGV/SIGABRT inside XLA:CPU near the end of
    the suite — in whatever heavy work comes next (compile, or cache
    serialize/deserialize), at different tests on different runs, and
    never when any subset of the suite runs alone. That signature is
    resource exhaustion from accumulated live executables, not a bug in
    any one test. Dropping JAX's in-process caches every few modules
    bounds the accumulation; the persistent disk cache keeps the
    recompiles cheap. The period trades wall-clock (each clear forces
    cross-module retraces) against headroom below the crash threshold:
    measured period=1 573 s, period=3 440 s green, no-clear 421 s then
    SIGSEGV at ~95% — period 3 keeps most of the savings at ~1/5 the
    peak accumulation. Override with VSTAB_TEST_CLEAR_PERIOD for
    experiments."""
    yield
    _modules_since_clear[0] += 1
    if _modules_since_clear[0] >= int(
            os.environ.get("VSTAB_TEST_CLEAR_PERIOD", "3")):
        _modules_since_clear[0] = 0
        jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_textured(h, w, seed=0, sigma=2.0):
    """Smooth random texture in [0, 255] — featureful synthetic content."""
    r = np.random.default_rng(seed)
    img = r.random((h, w)).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), sigma)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return (img * 255.0).astype(np.float32)


def make_bgr(h, w, seed=0):
    r = np.random.default_rng(seed)
    img = np.stack([make_textured(h, w, seed + i) for i in range(3)], axis=-1)
    return img.astype(np.float32)


@pytest.fixture(scope="session")
def jittered_clip():
    """A synthetic clip: a larger textured world viewed through a jittering
    window — known camera motion, featureful content."""
    world = make_textured(200, 300, seed=7, sigma=2.0)
    r = np.random.default_rng(42)
    frames, motions = [], []
    x0, y0 = 30.0, 30.0
    for _ in range(24):
        dx, dy = r.normal(0.0, 2.0, 2)
        m = np.float32([[1, 0, -(x0 + dx)], [0, 1, -(y0 + dy)]])
        f = cv2.warpAffine(world, m, (128, 96))
        frames.append(np.repeat(f[:, :, None], 3, 2).astype(np.uint8))
        motions.append((dx, dy))
    return frames, motions
