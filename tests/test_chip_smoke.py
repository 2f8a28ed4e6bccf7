"""chip_smoke.py on the CPU: it refuses to run without a GPU (before any
heavy work, printing no result line), and its phases run end to end at
tiny sizes, so the script's own code is checked before it reaches a card.
"""

import os
import shutil
import subprocess
import sys
import time

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_PAGE = dict(n_lines=2, words_per_line=2, H=500, W=460, char_h=40,
                 char_w=26, gap=5, space_w=30, line_spacing=140,
                 speckles=10, margin_x=25)


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    return proc, time.perf_counter() - t0


def test_exits_nonzero_without_gpu():
    proc, dt = _run(REPO, "chip_smoke.py")
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout
    assert dt < 60  # refused before any phase ran


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc, _ = _run(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    s = chip_smoke.Smoke(
        work=str(tmp_path_factory.mktemp("smoke")), page_kw=TINY_PAGE,
        n_batch=3, n_cards_folios=2, train_shape=(8, 64),
        lstm_shape=(8, 64), nw_sizes=(255,), nw_crossover=128,
        serve_warmup=False, reps=1)
    chip_smoke.setup(s)
    return s


@pytest.mark.parametrize("phase", ["align", "batch", "serve", "train",
                                   "timings"])
def test_phase_runs_at_tiny_size(smoke, phase, capsys):
    summary = getattr(chip_smoke, f"phase_{phase}")(smoke)
    assert isinstance(summary, str) and summary


def test_phase_cards_on_four_virtual_devices(smoke):
    assert "match one device" in chip_smoke.phase_cards(smoke, 4)
