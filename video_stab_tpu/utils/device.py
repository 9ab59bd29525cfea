"""The backend guard of the entry points that run on the card.

JAX falls back to the CPU, with only a warning, when its CUDA plugin fails
to start. A served stream or a benchmark that quietly ran on the CPU would
report a number for the wrong device, so the entry points refuse it.
"""

from __future__ import annotations

import os


def cpu_requested() -> bool:
    """True when JAX_PLATFORMS asks for the CPU backend alone."""
    return os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"


def require_gpu(allow_requested_cpu: bool = True):
    """Return the default device, which must be a GPU.

    With ``allow_requested_cpu`` an explicit ``JAX_PLATFORMS=cpu`` is
    honoured (tests, CPU development); anything else that does not land on
    a GPU raises ``RuntimeError``.
    """
    import jax

    backend = jax.default_backend()
    dev = jax.devices()[0]
    if backend == "gpu" and dev.platform == "gpu":
        return dev
    if allow_requested_cpu and cpu_requested():
        return dev
    raise RuntimeError(
        f"no GPU backend: default_backend={backend!r}, "
        f"devices()[0].platform={dev.platform!r}; set JAX_PLATFORMS=cpu "
        "to run on the CPU on purpose")
