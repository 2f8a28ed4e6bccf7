#!/usr/bin/env python3
"""GPU smoke test of the alignment pipeline: the quickest proof that the
system starts, and is right, on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --cards 4  # four GPUs: only the sharded paths

One process drives the main path through the entry points a user calls, at
the full width of the shipped recognizer (BiLSTM ni=48, ns=100, random
weights from a seed) on bench-sized synthetic folios (2000x1600, 10 lines):

1. align    ``align --backend hybrid`` through ``cli.main`` on two folios:
            once with the recognizer (device OCR), once on injected OCR
            pickles, where the JSON spells the transcript and is
            byte-identical to ``--backend host``;
2. batch    12 folios through the pipelined batched path (device skew,
            async OCR worker), injected-OCR parity with the host path, and
            one recognizer sweep over every strip of the 12 folios;
3. serve    ``serve --once --warmup`` on a spool of 3 jobs, then again with
            ``--batch 3``: byte-identical outputs;
4. train    5 trainer steps at B=128, T=512 with finite loss;
5. parity   the ``gpu`` test lane (tests/test_gpu_hw.py), in-process;
6. timings  the XLA paths on the card: the line normalizer, the fused OCR
            program, the BiLSTM scan, NW fill + traceback and the scoring
            grid, host vs device NW fill, the device raster programs.

``--cards 4`` runs only the sharded paths (data-mesh folio pipeline with
the sharded recognizer, data-parallel train step, sharded scoring grid),
each against its one-device result.

Earlier lines name the card (``nvidia-smi`` name and power limit), the
device kind, the compile-cache directory and the native raster engine, and
give each phase's result and time. The last line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU, outside a checkout of this repository, or when any phase
fails, the script exits non-zero and prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np

SEED = 1234
ROOT = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Smoke:
    """Sizes of one smoke run and its scratch directory. The defaults are
    the full sizes; the CPU tests shrink them."""

    work: str
    page_kw: dict | None = None   # synth.make_page geometry; None = bench
    n_batch: int = 12             # folios in the batch phase
    n_cards_folios: int = 8       # folios in the --cards phase
    train_shape: tuple = (128, 512)   # (B, T) of the train phase
    lstm_shape: tuple = (128, 2048)   # (B, T) of the BiLSTM timing
    nw_sizes: tuple = (8191, 16383)   # square NW timings
    nw_crossover: int = 2048      # host vs device fill timing
    serve_warmup: bool = True
    reps: int = 3                 # timing repetitions (best of)
    model_path: str = ""

    def pages(self, n, seed):
        from text_alignment_tpu.synth import bench_page, make_page

        if self.page_kw is None:
            return [bench_page(seed + i) for i in range(n)]
        return [make_page(np.random.default_rng(seed + i), **self.page_kw)
                for i in range(n)]

    def subdir(self, *parts):
        d = os.path.join(self.work, *parts)
        os.makedirs(d, exist_ok=True)
        return d


def _say(msg):
    print(msg, flush=True)


def _quiet(fn, *args, **kw):
    """Run fn with its stdout captured (the CLI and server narrate every
    folio); the capture is printed only if fn raises."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kw)
    except BaseException:
        sys.stdout.write(buf.getvalue()[-4000:])
        raise


def _best(fn, reps):
    """Warm call (compile), then the best wall time of ``reps`` calls.
    ``fn`` must block until the device is done (np.asarray of a result)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _injected_ocr(page, seed):
    from text_alignment_tpu.synth import corrupt_ocr, ocr_with_spaces

    return ocr_with_spaces(corrupt_ocr(np.random.default_rng(seed),
                                       page.char_boxes))


def _recognizer_params():
    import jax

    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.models.lstm_jax import init_bilstm

    codec = Codec()
    return init_bilstm(jax.random.PRNGKey(SEED), 48, 100, len(codec)), codec


def setup(s: Smoke) -> None:
    """Write the full-width random-weight recognizer as a .pyrnn.gz."""
    from text_alignment_tpu.models.lstm_jax import params_to_np
    from text_alignment_tpu.models.pyrnn import save_pyrnn

    params, codec = _recognizer_params()
    s.model_path = os.path.join(s.subdir("model"), "smoke-00000000.pyrnn.gz")
    save_pyrnn(s.model_path, params_to_np(params), codec, 48)


def _json_dumps(results):
    return [None if r is None else json.dumps(r.json_dict, sort_keys=True)
            for r in results]


def _strips_of(pages):
    from text_alignment_tpu.pipeline.preprocess import (
        identify_text_lines,
        preprocess_images,
    )

    strips = []
    for p in pages:
        image, eroded, _ = preprocess_images(p.image, backend="hybrid")
        ls, _, _ = identify_text_lines(image, eroded, backend="hybrid",
                                       verbose=False)
        strips.extend(np.asarray(x.img) for x in ls)
    return strips


# ---------------------------------------------------------------------------
# phases (each returns a one-line summary; any exception fails the phase)
# ---------------------------------------------------------------------------

def phase_align(s: Smoke) -> str:
    from text_alignment_tpu.cli import main as cli_main
    from text_alignment_tpu.lang.syllabify import syllabify_text
    from text_alignment_tpu.textio import write_png

    pages = s.pages(2, SEED)
    ids = ["001r", "002r"]
    png = s.subdir("align", "png")
    for fid, page in zip(ids, pages):
        write_png(os.path.join(png, f"smoke_{fid}_text.png"), page.image)
    csv_path = os.path.join(s.subdir("align"), "chants.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["h"] * 15)
        for i, (fid, page) in enumerate(zip(ids, pages)):
            row = [""] * 15
            row[2], row[3], row[10], row[14] = fid, str(i + 1), "1", \
                page.transcript
            w.writerow(row)
    common = ["align", "--csv", csv_path, "--manuscript", "smoke",
              "--model", s.model_path, "--png-dir", png, "--folios", *ids]

    t0 = time.perf_counter()
    out_model = s.subdir("align", "json_model")
    assert _quiet(cli_main, common + ["--backend", "hybrid",
                                      "--out-json", out_model]) == 0
    t_model = time.perf_counter() - t0

    outs = {}
    for backend in ("hybrid", "host"):
        pik = s.subdir("align", f"pik_{backend}")
        for i, (fid, page) in enumerate(zip(ids, pages)):
            with open(os.path.join(pik, f"smoke_{fid}_boxes.pickle"),
                      "wb") as f:
                pickle.dump(_injected_ocr(page, SEED + 50 + i), f, -1)
        out = s.subdir("align", f"json_{backend}")
        assert _quiet(cli_main, common + [
            "--backend", backend, "--out-json", out, "--pickle-dir", pik,
            "--reuse-ocr"]) == 0
        outs[backend] = {}
        for fid in ids:
            with open(os.path.join(out, f"smoke_{fid}.json"), "rb") as f:
                outs[backend][fid] = f.read()
    assert outs["hybrid"] == outs["host"], "hybrid JSON differs from host"
    n_syl = n_want = 0
    for fid, page in zip(ids, pages):
        syls = [b["syl"] for b in json.loads(outs["hybrid"][fid])["syl_boxes"]]
        want = syllabify_text(page.transcript)
        assert syls, f"{fid}: empty syl_boxes"
        # the boxes spell the transcript in order; a syllable whose
        # characters the corrupted OCR lost may be missing
        it = iter(want)
        assert all(x in it for x in syls) and len(syls) >= 0.8 * len(want), \
            f"{fid}: syl_boxes {syls} do not spell the transcript {want}"
        n_syl += len(syls)
        n_want += len(want)
    return (f"model run {t_model:.1f}s ({len(os.listdir(out_model))} of "
            f"{len(ids)} folios alignable on random weights); injected-OCR "
            f"JSON byte-identical to host; {n_syl} of {n_want} transcript "
            f"syllables boxed, in order")


def phase_batch(s: Smoke) -> str:
    from text_alignment_tpu.ops import skew_device
    from text_alignment_tpu.parallel.batch import process_batch
    from text_alignment_tpu.pipeline.process import _resolve_recognizer

    rec = _resolve_recognizer(s.model_path, "hybrid")
    pages = s.pages(s.n_batch, SEED + 10)
    folios = [(p.image, p.transcript) for p in pages]
    # lap 1 compiles; lap 2 dispatches at the frame bucket lap 1 learned
    # (new programs); lap 3 is the steady state
    laps, runs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        runs.append(_json_dumps(process_batch(folios, rec, backend="hybrid")))
        laps.append(time.perf_counter() - t0)
    assert len(runs[-1]) == len(folios)
    assert runs[0] == runs[1] == runs[2], "batch not repeatable"

    inj = [_injected_ocr(p, SEED + 100 + i) for i, p in enumerate(pages)]
    hyb = process_batch(folios, None, backend="hybrid", existing_ocr=inj)
    host = process_batch(folios, None, backend="host", existing_ocr=inj)
    assert all(r is not None for r in host)
    assert _json_dumps(hyb) == _json_dumps(host), "hybrid != host JSON"

    strips = _strips_of(pages)
    t0 = time.perf_counter()
    rows = rec.recognize_batch(strips)
    t_sweep = time.perf_counter() - t0
    assert len(rows) == len(strips)
    return (f"{len(folios)} folios pipelined, laps "
            f"{', '.join(f'{t:.2f}s' for t in laps)} (steady "
            f"{len(folios) / laps[-1]:.2f} folios/s; device OCR "
            f"normalize={rec.normalize_on_device}, device "
            f"skew={skew_device.enabled()}); injected-OCR JSON identical "
            f"to host; sweep of {len(strips)} strips in {t_sweep:.1f}s "
            f"(first call, compile included)")


def _make_spool(s: Smoke, name, pages):
    from text_alignment_tpu.textio import write_png

    spool = s.subdir("serve", name)
    for i, page in enumerate(pages):
        job = f"folio_{i}"
        write_png(os.path.join(spool, job + ".png"), page.image)
        with open(os.path.join(spool, job + ".pickle"), "wb") as f:
            pickle.dump(_injected_ocr(page, SEED + 200 + i), f, -1)
        with open(os.path.join(spool, job + ".job.json"), "w") as f:
            json.dump({"image": job + ".png", "transcript": page.transcript,
                       "existing_ocr_pickle": job + ".pickle"}, f)
    return spool


def phase_serve(s: Smoke) -> str:
    from text_alignment_tpu.cli import main as cli_main

    pages = s.pages(3, SEED + 20)
    outs = {}
    times = {}
    for name, extra in (("single", []), ("batch", ["--batch", "3"])):
        spool = _make_spool(s, name, pages)
        argv = ["serve", "--spool", spool, "--model", s.model_path,
                "--once"] + (["--warmup"] if s.serve_warmup else []) + extra
        t0 = time.perf_counter()
        assert _quiet(cli_main, argv) == 0, f"serve {name} failed"
        times[name] = time.perf_counter() - t0
        done = sorted(x for x in os.listdir(spool) if x.endswith(".done"))
        assert len(done) == len(pages), done
        outs[name] = []
        for i in range(len(pages)):
            with open(os.path.join(spool, f"folio_{i}.json"), "rb") as f:
                outs[name].append(f.read())
    assert outs["single"] == outs["batch"], "serve --batch output differs"
    return (f"3 jobs served ({times['single']:.1f}s single, "
            f"{times['batch']:.1f}s --batch 3, warmup included); outputs "
            f"byte-identical")


def phase_train(s: Smoke) -> str:
    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.models.train import Trainer

    codec = Codec()
    tr = Trainer(codec=codec)
    B, T = s.train_shape
    S = 48
    rng = np.random.default_rng(SEED)
    xs = (rng.random((B, T, 48)) < 0.1).astype(np.float32)
    xlens = np.full(B, T, np.int32)
    labels = rng.integers(1, len(codec), (B, S)).astype(np.int32)
    llens = np.full(B, S, np.int32)
    t0 = time.perf_counter()
    losses = [tr.step(xs, xlens, labels, llens)]
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses += [tr.step(xs, xlens, labels, llens) for _ in range(4)]
    dt = (time.perf_counter() - t0) / 4
    assert np.all(np.isfinite(losses)), losses
    return (f"5 steps at B={B}, T={T}: loss {losses[0]:.3f} -> "
            f"{losses[-1]:.3f}; first step {t_first:.1f}s (compile), then "
            f"{dt * 1e3:.1f} ms/step")


class _Outcomes:
    """pytest plugin counting test outcomes (a skipped GPU test must fail
    the parity phase, not pass it)."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_parity(s: Smoke) -> str:
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main([os.path.join(ROOT, "tests", "test_gpu_hw.py"), "-q",
                      "-s", "-p", "no:cacheprovider", "-m", "gpu"],
                     plugins=[outcomes])
    c = outcomes.counts
    assert rc == 0 and c["failed"] == 0 and c["skipped"] == 0 \
        and c["passed"] > 0, f"gpu lane rc={rc} {c}"
    return f"gpu test lane: {c['passed']} passed"


def phase_timings(s: Smoke) -> str:
    """Times of the XLA paths at real shapes (best of ``s.reps`` warm
    calls, compile excluded), one line each."""
    import random

    import jax.numpy as jnp

    from text_alignment_tpu.align import nw_jax, perform_alignment
    from text_alignment_tpu.align.api import align_grid
    from text_alignment_tpu.align.scoring import resolve_scoring
    from text_alignment_tpu.evaluate import scoring_grid
    from text_alignment_tpu.models.lineest_jax import normalize_batch_device
    from text_alignment_tpu.models.lstm_jax import bilstm_forward_batched
    from text_alignment_tpu.models.recognizer import (
        SeqRecognizer,
        _recognize_device,
    )
    from text_alignment_tpu.ops import cc_runs, oracle, raster_device

    params, codec = _recognizer_params()
    rec = SeqRecognizer(params, codec, normalize_on_device=True)
    pages = s.pages(s.n_batch, SEED + 10)
    sweep = _strips_of(pages)
    folio = _strips_of(pages[:1])

    # line normalizer at the sweep and per-folio shape
    for label, strips in (("sweep", sweep), ("folio", folio)):
        meta, hs, ws, Wp = rec._pack_strips(strips)
        B, Hp = meta.shape[0], meta.shape[1] - 1
        bits = np.unpackbits(meta[:, :Hp].view(np.uint8), axis=2,
                             bitorder="little")
        grey = jnp.asarray(1 - bits)
        hs_j, ws_j = jnp.asarray(hs), jnp.asarray(ws)
        t_max = min(8192, -(-Wp // 128) * 128)
        dt = _best(lambda: np.asarray(normalize_batch_device(
            grey, hs_j, ws_j, t_max=t_max, onebit=True)[1]), s.reps)
        _say(f"timing normalize_batch_device {label} B={B} Hp={Hp} "
             f"Wp={Wp} t_max={t_max}: {dt * 1e3:.2f} ms")

    # the fused OCR program over the sweep (bits resident on device)
    meta, hs, ws, Wp = rec._pack_strips(sweep)
    pm = jnp.asarray(meta)
    t_max = rec._initial_t_max(Wp, ws[: len(sweep)])
    dt = _best(lambda: np.asarray(_recognize_device(
        params, pm, t_max=t_max, target_height=48, pad=16, max_regions=128,
        decode="region")), s.reps)
    _say(f"timing fused OCR sweep B={meta.shape[0]} strips={len(sweep)} "
         f"Wp={Wp} t_max={t_max}: {dt * 1e3:.2f} ms "
         f"({len(sweep) / dt:.0f} strips/s)")

    # BiLSTM recurrence
    B, T = s.lstm_shape
    rng = np.random.default_rng(SEED)
    xs = jnp.asarray(rng.random((B, T, 48)).astype(np.float32))
    lens = jnp.full((B,), T, jnp.int32)
    dt = _best(lambda: np.asarray(bilstm_forward_batched(
        params, xs, lens)[0, 0]), s.reps)
    _say(f"timing bilstm_forward_batched B={B} T={T} ni=48 ns=100: "
         f"{dt * 1e3:.2f} ms ({dt / T * 1e6:.2f} us/step)")

    # NW fused fill + traceback (square pairs), and host vs device fill
    sc = resolve_scoring(None)
    r = random.Random(0)
    for n in s.nw_sizes:
        t = [r.choice("abcdefgh ") for _ in range(n)] + [" "]
        o = [r.choice("abcdefgh ") for _ in range(n)] + [" "]
        dt = _best(lambda: nw_jax.align_jax_ops(t, o, sc), s.reps)
        _say(f"timing nw fill+traceback {n + 1}^2: {dt * 1e3:.1f} ms "
             f"({(n + 1) ** 2 / dt / 1e9:.3f} GCUPS)")
    n = s.nw_crossover
    t = [r.choice("abcdefgh ") for _ in range(n)]
    o = [r.choice("abcdefgh ") for _ in range(n)]
    dt_host = _best(lambda: perform_alignment(t, o, backend="host"), s.reps)
    dt_dev = _best(lambda: perform_alignment(t, o, backend="jax"), s.reps)
    _say(f"timing nw crossover {n}^2: host fill {dt_host * 1e3:.1f} ms, "
         f"device fill {dt_dev * 1e3:.1f} ms (perform_alignment, "
         f"traceback and replay included)")

    # the 729-combination scoring grid on a chant-page pair
    page = pages[0]
    tra = list(page.transcript)
    ocr = [c.char for c in _injected_ocr(page, SEED + 300)]
    grid = scoring_grid()
    dt = _best(lambda: align_grid(tra, ocr, grid), s.reps)
    _say(f"timing align_grid 729 combos {len(tra)}x{len(ocr)}: "
         f"{dt:.2f} s ({len(grid) / dt:.0f} combos/s)")

    # device raster programs A (clean+skew+rotate+erode+project) and B
    img = oracle.to_onebit(page.image)
    H, W = img.shape
    fa, _ = raster_device._jit_raster_page(H, W, -6.0, 6.0, cc_runs.MAX_RUNS)
    fb = raster_device._jit_masked_cc_table(4096, cc_runs.MAX_RUNS)
    a_args = (jnp.asarray(raster_device.pack_page(img)), jnp.int32(100),
              jnp.int32(150))
    eroded = fa(*a_args)[1]
    b_args = (eroded, jnp.zeros(eroded.shape[0], bool), jnp.int32(100))
    for name, fn, args in (("A", fa, a_args), ("B", fb, b_args)):
        dt = _best(lambda: np.asarray(fn(*args)[-1]), s.reps)
        _say(f"timing device raster program {name} {H}x{W} page: "
             f"{dt * 1e3:.2f} ms")
    return "XLA paths timed at real shapes"


def phase_cards(s: Smoke, n: int) -> str:
    """The sharded paths on n devices, each against its one-device run."""
    import numpy.testing as npt

    from text_alignment_tpu.align.api import align_grid
    from text_alignment_tpu.evaluate import scoring_grid
    from text_alignment_tpu.parallel import (
        data_model_mesh,
        infer_dp,
        make_mesh,
        sharded_train_demo_step,
    )
    from text_alignment_tpu.models.recognizer import SeqRecognizer
    from text_alignment_tpu.parallel.batch import process_batch

    mesh, mesh1 = make_mesh(n), make_mesh(1)
    # the sharded recognizer is the device-normalized one
    rec = SeqRecognizer.from_pyrnn(s.model_path)
    rec.normalize_on_device = True
    pages = s.pages(s.n_cards_folios, SEED + 30)
    folios = [(p.image, p.transcript) for p in pages]
    one = process_batch(folios, rec, backend="hybrid", mesh=mesh1)
    t0 = time.perf_counter()
    many = process_batch(folios, rec, backend="hybrid", mesh=mesh)
    t_first = time.perf_counter() - t0
    shares = dict(infer_dp.LAST_WORK_SHARES)
    t0 = time.perf_counter()
    process_batch(folios, rec, backend="hybrid", mesh=mesh)
    t_warm = time.perf_counter() - t0
    assert _json_dumps(one) == _json_dumps(many), \
        "sharded folio pipeline differs from one device"
    assert len(shares) == n and len(set(shares.values())) == 1, shares
    _say(f"cards: folio pipeline on {n} devices byte-identical to 1 "
         f"({len(folios)} folios, {t_first:.1f}s first, {t_warm:.2f}s "
         f"warm); recognizer work shares {shares}")

    dmesh = data_model_mesh(n)
    bpd = 16
    B = bpd * dmesh.shape["data"]
    kw = dict(T=s.train_shape[1], ni=48, ns=100, seed=SEED)
    l_n = sharded_train_demo_step(dmesh, batch_per_device=bpd, **kw)
    l_1 = sharded_train_demo_step(data_model_mesh(1), batch_per_device=B,
                                  **kw)
    npt.assert_allclose(l_n, l_1, rtol=1e-5)
    _say(f"cards: data-parallel train step mesh={dict(dmesh.shape)} "
         f"B={B}: loss {l_n:.6f} vs one device {l_1:.6f}")

    page = pages[0]
    tra = list(page.transcript)
    ocr = [c.char for c in _injected_ocr(page, SEED + 300)]
    grid = scoring_grid()
    assert align_grid(tra, ocr, grid, mesh=mesh) == align_grid(tra, ocr,
                                                               grid)
    _say(f"cards: sharded scoring grid ({len(grid)} combos over {n} "
         f"devices) identical to one device")
    return f"sharded paths on {n} devices match one device"


# ---------------------------------------------------------------------------


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    try:
        import jax

        devices = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: no GPU: {e}", file=sys.stderr)
        return 2
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX runs on {devices[0].platform}",
              file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs; "
              f"JAX finds {len(devices)}", file=sys.stderr)
        return 2
    try:
        from text_alignment_tpu.ops import host_native
        from text_alignment_tpu.utils.compile_cache import (
            ensure_compile_cache,
        )
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository: {e}",
              file=sys.stderr)
        return 2

    for line in _card_line().splitlines():
        _say(f"card: {line}")
    _say(f"device_kind: {devices[0].device_kind} x{len(devices)}")
    ensure_compile_cache()
    _say(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    if not host_native.available():
        print(f"chip_smoke: native engine not loaded: "
              f"{host_native.load_error()}", file=sys.stderr)
        return 1
    _say("native engine loaded")

    os.makedirs(os.path.join(ROOT, ".cache"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=os.path.join(ROOT, ".cache"))
    s = Smoke(work=work)
    if args.cards > 1:
        phases = [("cards", lambda s: phase_cards(s, args.cards))]
    else:
        phases = [("align", phase_align), ("batch", phase_batch),
                  ("serve", phase_serve), ("train", phase_train),
                  ("parity", phase_parity), ("timings", phase_timings)]
    failed = []
    try:
        setup(s)
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                summary = fn(s)
            except Exception:
                traceback.print_exc()
                failed.append(name)
                _say(f"phase {name}: FAILED after "
                     f"{time.perf_counter() - t0:.1f}s")
                continue
            _say(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s: "
                 f"{summary}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
