"""Which engine runs each pipeline stage, by platform — the one place the
routing lives.

The platform is read WITHOUT initializing a JAX backend where a pin says
it (``jax.config.jax_platforms`` or ``JAX_PLATFORMS``): pure-host runs
(``backend="host"``, injected OCR) never pay backend start-up. Only when
nothing is pinned does it ask ``jax.default_backend()``.
"""

import os

# stage -> (engine on the CPU, engine on an accelerator)
_ENGINES = {
    # hybrid NW: the native host fill beats paying an XLA scan compile for
    # every size bucket on XLA:CPU; on an accelerator, pairs route by size
    # (align.api.auto_device_min_cells)
    "nw": ("host", "auto"),
    # 729-combination scoring grid (evaluate.grid_search); on an
    # accelerator, fixtures route by pair size
    "grid": ("host", "auto"),
    # per-folio skew search (ops.skew_device)
    "skew": ("host", "device"),
    # recognizer line normalization (models.lineest_jax)
    "ocr_normalize": ("host", "device"),
}


def platform() -> str:
    """Name of the platform JAX runs on: ``"cpu"``, ``"gpu"``, ...

    Reads the pin from ``jax.config.jax_platforms`` (which reflects both
    the ``JAX_PLATFORMS`` env var and a ``jax.config.update`` pin), then
    from the env var when jax is not importable, and only when nothing is
    pinned from ``jax.default_backend()``, which initializes the backend.
    A pin of ``"cuda"`` or ``"rocm"`` reads as ``"gpu"``, as JAX reports it.
    """
    try:
        import jax

        plat = jax.config.jax_platforms or ""
    except ImportError:
        plat = os.environ.get("JAX_PLATFORMS") or ""
    plat = plat.split(",")[0].strip().lower()
    if not plat:
        import jax

        plat = jax.default_backend()
    return "gpu" if plat in ("cuda", "rocm") else plat


def accel_platform() -> bool:
    """True when JAX runs on an accelerator, not XLA:CPU."""
    return platform() != "cpu"


def engine(stage: str, plat: str | None = None) -> str:
    """Engine for ``stage`` (a key of the routing table) on ``plat``
    (default: :func:`platform`)."""
    cpu_engine, accel_engine = _ENGINES[stage]
    plat = platform() if plat is None else plat
    return cpu_engine if plat == "cpu" else accel_engine
