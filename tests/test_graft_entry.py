"""Driver-facing entry points (__graft_entry__.py).

The multi-device dry runs must pin their children to the CPU themselves.
These tests invoke the entry points from an env with the platform pin
stripped, so the child bootstrap must pin CPU on its own.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_driver_form_is_hermetic():
    env = dict(os.environ)
    # worst-case environment: no platform pin at all — the bootstrap must
    # pin CPU itself
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env.pop("_TA_DRYRUN_CHILD", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, (
        f"dryrun_multichip(8) failed\nstdout:\n{proc.stdout}\n"
        f"stderr:\n{proc.stderr}"
    )
    assert "sharded folio pipeline ok" in proc.stdout


def test_dryrun_multihost_two_processes():
    """Multi-host (DCN stand-in) dry run: 2 jax.distributed processes x 4
    virtual CPU devices, sharded train step + OCR batch + folio pipeline +
    scoring grid spanning the process boundary via Gloo collectives
    (SURVEY §5:315-320)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multihost(2, 4)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, (
        f"dryrun_multihost(2, 4) failed\nstdout:\n{proc.stdout}\n"
        f"stderr:\n{proc.stderr}"
    )
    assert "sharded folio pipeline ok, JSON byte-identical" in proc.stdout
    assert "train step ok" in proc.stdout


def test_entry_compiles_single_chip():
    import jax

    import __graft_entry__ as g

    import numpy as np

    fn, args = g.entry()
    out = np.asarray(jax.jit(fn).lower(*args).compile()(*args))
    assert out.shape == (8, 256, 64)
    assert np.isfinite(out).all()
    # posteriors: each frame's distribution sums to 1
    np.testing.assert_allclose(out.sum(axis=2), 1.0, rtol=1e-4)


def test_compile_cache_gated_off_on_cpu():
    """The persistent XLA compile cache must never be enabled on the CPU
    backend (the XLA:CPU AOT path is several times slower and never
    hits)."""
    import jax

    from text_alignment_tpu import ensure_compile_cache

    assert jax.default_backend() == "cpu"  # conftest pins CPU
    assert ensure_compile_cache() is False
    assert jax.config.jax_compilation_cache_dir is None
