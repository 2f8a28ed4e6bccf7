"""Platform routing (utils.platform), the compile-cache directory, mesh
construction on too few devices, the native engine's build directory, and
the benchmark's refusal to measure without a GPU."""

import os
import subprocess
import sys

import pytest

from text_alignment_tpu.utils import compile_cache
from text_alignment_tpu.utils import platform as plat_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAGES = [
    # stage, engine on the CPU, engine on an accelerator
    ("nw", "host", "auto"),
    ("grid", "host", "auto"),
    ("skew", "host", "device"),
    ("ocr_normalize", "host", "device"),
]


@pytest.mark.parametrize("plat", ["cpu", "gpu"])
@pytest.mark.parametrize("stage,on_cpu,on_accel", STAGES)
def test_engine_by_platform_and_stage(plat, stage, on_cpu, on_accel):
    want = on_cpu if plat == "cpu" else on_accel
    assert plat_mod.engine(stage, plat) == want


def test_engine_rejects_unknown_stage():
    with pytest.raises(KeyError):
        plat_mod.engine("raster", "cpu")


def test_default_platform_is_the_pinned_cpu():
    assert plat_mod.platform() == "cpu"
    assert not plat_mod.accel_platform()
    assert plat_mod.engine("skew") == "host"


@pytest.mark.parametrize("pin,want", [("cuda", "gpu device"),
                                      ("cpu,cuda", "cpu host")])
def test_routing_reads_the_pin_without_starting_a_backend(pin, want):
    """A pin decides the routing without initializing a backend: a CUDA
    pin routes to the device even where no CUDA backend could start."""
    env = dict(os.environ, JAX_PLATFORMS=pin,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    code = ("from text_alignment_tpu.utils.platform import platform, "
            "engine; print(platform(), engine('skew'))")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == want


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.cache_dir()
    assert d == os.path.join(REPO, ".cache", "xla")


@pytest.mark.parametrize("env_dir", [None, "/var/cache/xla-test"])
def test_ensure_compile_cache_on_accelerator(monkeypatch, env_dir):
    """On an accelerator the cache goes to the checkout directory, unless
    JAX_COMPILATION_CACHE_DIR is set: then no directory is set in code."""
    import jax

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    monkeypatch.delenv("TEXT_ALIGNMENT_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(compile_cache, "_state", {})
    monkeypatch.setattr(plat_mod, "accel_platform", lambda: True)
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    assert compile_cache.ensure_compile_cache() is True
    if env_dir is None:
        assert updates["jax_compilation_cache_dir"] == os.path.join(
            REPO, ".cache", "xla")
    else:
        assert "jax_compilation_cache_dir" not in updates


@pytest.mark.parametrize("builder", ["make_mesh", "data_model_mesh"])
def test_mesh_raises_when_devices_are_short(builder):
    """A mesh never borrows another backend's devices: asking the 8-device
    test backend for 16 raises."""
    import jax

    from text_alignment_tpu import parallel

    assert len(jax.devices()) == 8
    with pytest.raises(ValueError, match="need 16 devices"):
        getattr(parallel, builder)(16)


def test_native_engine_builds_inside_checkout():
    from text_alignment_tpu.ops import host_native

    if not host_native.available():
        pytest.skip(f"native engine unavailable: {host_native.load_error()}")
    assert host_native.load_error() is None
    built = os.listdir(os.path.join(REPO, ".cache", "native"))
    assert any(f.startswith("raster_") and f.endswith(".so") for f in built)


def test_bench_refuses_to_run_without_gpu(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import bench

    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()


def test_bench_refuses_to_run_without_native_engine(monkeypatch):
    """On a GPU, the hybrid benchmark exits when the native raster engine
    did not load instead of timing the numpy oracle in its place."""
    import types

    import jax

    from text_alignment_tpu.ops import host_native

    monkeypatch.syspath_prepend(REPO)
    import bench

    gpu = types.SimpleNamespace(platform="gpu", device_kind="test GPU")
    monkeypatch.setattr(jax, "devices", lambda *a: [gpu])
    monkeypatch.setattr(bench, "DEVICE_BACKEND", "hybrid")
    monkeypatch.setattr(host_native, "available", lambda: False)
    monkeypatch.setattr(host_native, "load_error", lambda: "no compiler")
    with pytest.raises(SystemExit, match="native engine.*no compiler"):
        bench.main()
