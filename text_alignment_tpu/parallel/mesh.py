"""Device-mesh construction for multi-device scale-out.

The reference's only concurrency was two ocropus worker processes and
Rodan-level job fan-out (SURVEY.md §2, alignToOCR.py:24,143). Here the
scale-out story is a JAX mesh: folios/line-batches are data-parallel over
the devices, with an optional model axis for sharding the recognizer's
widest matmuls. Meshes are plain device lists (every device reaches every
other at the same rate); no custom comm layer: XLA emits the collectives.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def _devices_for(n: int | None):
    """The default backend's devices; raises when it has fewer than n (a
    mesh never borrows devices from another backend)."""
    devs = jax.devices()
    if n is not None and len(devs) < n:
        raise ValueError(
            f"need {n} devices; the {devs[0].platform} backend has "
            f"{len(devs)}"
        )
    return devs


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1-D data mesh over the first n devices."""
    devs = _devices_for(n_devices)
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis_name,))


def data_model_mesh(n_devices: int | None = None,
                    model_parallel: int | None = None) -> Mesh:
    """2-D ('data', 'model') mesh. model axis defaults to 2 when the device
    count allows, else 1 (pure DP)."""
    devs = _devices_for(n_devices)
    n = n_devices or len(devs)
    if model_parallel is None:
        model_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    assert n % model_parallel == 0
    grid = np.array(devs[:n]).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, ("data", "model"))
