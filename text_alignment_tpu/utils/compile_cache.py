"""Persistent XLA compilation cache for accelerator runs.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory. Otherwise the cache lives at a fixed path
inside the checkout (:func:`cache_dir`, listed in ``.gitignore``): the
directory is part of what a later process must find again, so it never
moves with ``HOME`` or the working directory.

On XLA:CPU the cache stays off: its AOT serialization path made steps
several times slower and never hit across processes (tests/conftest.py).
The platform is only known once the backend is chosen, hence this deferred
hook instead of an import-time config update: call
:func:`ensure_compile_cache` right before the first jit in any
device-facing entry point (CLI, serve, bench, recognizer).

Opt out entirely with ``TEXT_ALIGNMENT_TPU_NO_COMPILE_CACHE=1``.
"""

import os

# <checkout>/.cache: the compile cache and the native engine's build
LOCAL_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".cache",
)

_state: dict = {}


def cache_dir() -> str:
    """The compile-cache directory: ``$JAX_COMPILATION_CACHE_DIR`` when
    set, else ``<checkout>/.cache/xla``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(LOCAL_CACHE, "xla"))


def ensure_compile_cache() -> bool:
    """Enable the persistent XLA compile cache iff JAX runs on an
    accelerator.

    Idempotent. Returns True if the cache is (now) enabled, False if it
    was skipped (CPU backend or opt-out). May initialize the JAX backend,
    which is fine at every call site — they are all about to use devices.
    """
    if "enabled" in _state:
        return _state["enabled"]
    _state["enabled"] = False
    if os.environ.get("TEXT_ALIGNMENT_TPU_NO_COMPILE_CACHE"):
        return False
    from .platform import accel_platform

    if not accel_platform():
        return False
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _state["enabled"] = True
    return True
