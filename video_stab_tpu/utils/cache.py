"""Persistent-compilation-cache location.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives at a fixed absolute path
inside the checkout, ``<repo>/.jax_cache/host-<fingerprint>``: the path
is part of what a later process must find again, so it never depends on
the working directory, the time or the process.

XLA:CPU AOT executables embed the feature set of the machine that
compiled them, and loading an entry produced on a different host can
crash outright (observed: a full-suite run segfaulted inside
``compilation_cache.get_executable_and_time`` on a foreign entry; the
cpu_aot_loader had been warning "could lead to execution errors such as
SIGILL" about exactly those entries). JAX's cache key does not include
the host CPU features, so the directory is keyed by a fingerprint of the
CPU flags and entries written by another machine are never visible.
"""

import hashlib
import os
import platform

_FINGERPRINT = None

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def host_fingerprint() -> str:
    """Short stable id of this host's instruction-set surface."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        basis = platform.machine()
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if line.startswith(("flags", "Features")):
                        basis += " " + " ".join(sorted(line.split()[2:]))
                        break
        except OSError:
            basis += " " + platform.processor()
        _FINGERPRINT = hashlib.sha1(basis.encode()).hexdigest()[:12]
    return _FINGERPRINT


def compilation_cache_dir() -> str:
    """The directory the persistent cache uses when the environment names
    none: absolute, inside the checkout, keyed by the host."""
    return os.path.join(REPO_ROOT, ".jax_cache", "host-" + host_fingerprint())


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    it. ``JAX_COMPILATION_CACHE_DIR`` wins: when it is set, JAX already uses
    it and this sets nothing."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
