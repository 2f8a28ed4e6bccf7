"""End-to-end benchmark: folios/sec through the full alignment pipeline.

Prints ONE JSON line:
  {"metric": "folios/sec", "value": N, "unit": "folios/sec", "vs_baseline": N}

Flow per folio (identical stage graph on both paths):
  binarize -> despeckle x2 -> tall-CC removal -> skew detect -> rotate ->
  run filters -> projection/peaks -> separator CC analysis -> line strips ->
  BiLSTM+CTC recognizer over all strips -> affine-gap NW (transcript vs OCR
  char stream) -> abbreviation/syllable assembly -> JSON dict.

- device path (backend from TEXT_ALIGNMENT_TPU_BENCH_BACKEND, default
  "hybrid"): native C++ raster engine for the branch-heavy CC stages,
  batched JAX recognizer + wavefront NW fill on the GPU ("device" forces
  the all-XLA raster path; see pipeline.preprocess docs for why hybrid is
  the production default).
- baseline path: the host oracle pipeline with the *reference's* pure-Python
  NW fill (textSeqCompare.py:62-88 port) and the pure-numpy per-line LSTM —
  the faithful stand-in for the CPU reference stack, which is Python 2 +
  Gamera/OCRopus and cannot run here (SURVEY.md §0, §6).

OCR weights are untrained (the reference's trained .pyrnn blobs are stripped
from the mount), so the recognizer's *output* is not meaningful; its compute
is still timed at realistic shapes, and the NW/assembly stages run on an
injected OCR char stream with realistic error rates so alignment cost is
representative. Secondary metrics go to stderr. The bench needs a GPU: it
exits with an error when JAX finds none, and any failing metric fails the
run.
"""

import json
import os
import sys
import time

import numpy as np

BENCH_SEED = 1234

# -------------------------------------------------------------------------
# 12 folios per batch: the batched pipeline's tail (the last folio's OCR
# execution + the single combined download) is fixed per batch, so the
# per-folio number amortizes it at realistic serving batch sizes (the
# reference processes whole manuscripts, hundreds of folios)
N_DEVICE_FOLIOS = 12
N_BASELINE_FOLIOS = 5  # median of 5: host timings are noisy
DEVICE_BACKEND = os.environ.get("TEXT_ALIGNMENT_TPU_BENCH_BACKEND", "hybrid")


def folio_flow(page, ocr_chars, recognizer, backend):
    """One folio end-to-end; returns the JSON dict."""
    from text_alignment_tpu.pipeline import process, to_JSON_dict

    # OCR engine timing: run the recognizer over the page's strips (output
    # not used for alignment quality — weights are untrained)
    from text_alignment_tpu.pipeline.preprocess import (
        preprocess_images,
        identify_text_lines,
    )

    image, eroded, angle = preprocess_images(page.image, backend=backend)
    strips, peaks, _ = identify_text_lines(image, eroded, backend=backend,
                                           verbose=False)
    _ = recognizer.recognize_batch([s.img for s in strips])

    result = process(
        page.image,
        page.transcript,
        existing_ocr=ocr_chars,
        existing_preproc_images=(image, eroded, angle),
        verbose=False,
        backend=backend,
    )
    syl_boxes, _, lines_peak_locs, _ = result
    return to_JSON_dict(syl_boxes, lines_peak_locs)


def device_recognizer():
    import jax
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.models.recognizer import SeqRecognizer
    from text_alignment_tpu.models.codec import Codec

    codec = Codec()
    rec = SeqRecognizer(
        init_bilstm(jax.random.PRNGKey(0), 48, 100, len(codec)), codec,
        normalize_on_device=(DEVICE_BACKEND != "host"),
    )
    return rec


def baseline_recognizer():
    """Pure-numpy per-line recognizer (the ocropy-equivalent CPU path)."""
    import jax
    from text_alignment_tpu.models.lstm_jax import init_bilstm, params_to_np
    from text_alignment_tpu.models.lstm_np import bilstm_forward_np
    from text_alignment_tpu.models.ctc import translate_back_np
    from text_alignment_tpu.models.lineest import normalize_strip

    d = params_to_np(init_bilstm(jax.random.PRNGKey(0), 48, 100, 64))

    class _NpRec:
        def recognize_batch(self, strip_imgs):
            out = []
            for img in strip_imgs:
                norm = normalize_strip(img)
                if norm is None:
                    out.append([])
                    continue
                frames, _ = norm
                posteriors = bilstm_forward_np(d, frames)
                out.append(translate_back_np(posteriors))
            return out

    return _NpRec()


def injected_ocr(page, seed):
    from text_alignment_tpu.synth import corrupt_ocr, ocr_with_spaces

    rng = np.random.default_rng(seed)
    return ocr_with_spaces(corrupt_ocr(rng, page.char_boxes))


def ocr_metrics(pages, dev_rec):
    """Hardware-grounded recognizer throughput: strips/sec through the fused
    normalize->BiLSTM->CTC path, plus model FLOP/s from the BiLSTM flops
    model (2 dirs x 4 gate matmuls of (ns, 1+ni+ns) + softmax (nout, 2ns+1),
    2 flops/MAC) over the normalized frame count (width * 48/height)."""
    from text_alignment_tpu.pipeline.preprocess import (
        preprocess_images,
        identify_text_lines,
    )

    strips = []
    for p in pages[1:]:
        image, eroded, _ = preprocess_images(p.image, backend=DEVICE_BACKEND)
        ls, _, _ = identify_text_lines(image, eroded, backend=DEVICE_BACKEND,
                                       verbose=False)
        strips.extend(s.img for s in ls)
    frames = sum(
        int(round(s.shape[1] * 48.0 / max(1, s.shape[0]))) for s in strips
    )
    ni, ns, nout = 48, 100, 64
    flops_per_frame = 2 * (4 * 2 * ns * (1 + ni + ns)) + 2 * nout * (2 * ns + 1)
    dev_rec.recognize_batch(strips)  # warm the size buckets
    dt = float("inf")  # best of 3: host-side packing is noisy
    for _ in range(3):
        t0 = time.perf_counter()
        dev_rec.recognize_batch(strips)
        dt = min(dt, time.perf_counter() - t0)
    print(f"# ocr: {len(strips)/dt:.0f} strips/sec, "
          f"~{frames * flops_per_frame / dt / 1e9:.2f} model GFLOP/s "
          f"({len(strips)} strips, ~{frames} frames, fp32 parity path)",
          file=sys.stderr)

    # raw fused-program compute (no host packing, no upload, no
    # download): packed bits pre-placed on device, depth-8 pipelined
    import jax.numpy as jnp
    from text_alignment_tpu.models.recognizer import _recognize_device

    inks = [np.asarray(s) for s in strips]
    packed_meta, hs, ws, Wp = dev_rec._pack_strips(inks)
    t_max = dev_rec._initial_t_max(Wp, ws[: len(inks)])
    args = (jnp.asarray(packed_meta),)
    kw = dict(t_max=t_max, target_height=dev_rec.target_height,
              pad=dev_rec.pad, max_regions=128, decode=dev_rec.decode)
    np.asarray(_recognize_device(dev_rec.params, *args, **kw)[0, 0])
    K = 8
    t0 = time.perf_counter()
    for _ in range(K - 1):
        _recognize_device(dev_rec.params, *args, **kw)
    np.asarray(_recognize_device(dev_rec.params, *args, **kw)[0, 0])
    raw_dt = (time.perf_counter() - t0) / K
    print(f"# ocr raw compute (bits resident on device): "
          f"{len(strips)/raw_dt:.0f} strips/sec, "
          f"~{frames * flops_per_frame / raw_dt / 1e9:.2f} model "
          f"GFLOP/s", file=sys.stderr)


def nw_gcups_stress(n=8191):
    """Secondary metric: fused NW fill+traceback throughput at n x n
    (n chosen so the +1 sentinel keeps the padding bucket; only the
    O(N+M) op stream is downloaded). Best of 3."""
    import functools
    import random

    import jax
    import jax.numpy as jnp
    from text_alignment_tpu.align import nw_jax
    from text_alignment_tpu.align.scoring import resolve_scoring

    rng = random.Random(0)
    t = [rng.choice("abcdefgh ") for _ in range(n)] + [" "]
    o = [rng.choice("abcdefgh ") for _ in range(n)] + [" "]
    sc = resolve_scoring(None)
    nw_jax.align_jax_ops(t, o, sc)  # compile
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        nw_jax.align_jax_ops(t, o, sc)
        dt = min(dt, time.perf_counter() - t0)
    lat = ((n + 1) * (n + 1)) / dt / 1e9

    # pipelined throughput: K in-flight alignments, one download — the
    # shape of the grid-search / batch workloads
    t_ids, o_ids, S, match, mismatch, _, _ = nw_jax._encode(t, o, sc)
    L = NoP = nw_jax._bucket(n + 1)
    steps = -(-(L + NoP - 1) // nw_jax.UNROLL) * nw_jax.UNROLL
    t_ext = np.zeros(L, np.int32)
    t_ext[1:n + 1] = t_ids[:n]
    o_feed = np.zeros(steps, np.int32)
    o_feed[1:n + 1] = o_ids[:n]
    i32 = functools.partial(jnp.asarray, dtype=jnp.int32)
    scal = [i32(v) for v in (match, mismatch, sc.gap_open_x, sc.gap_open_y,
                             sc.gap_extend_x, sc.gap_extend_y, sc.bge_row0,
                             sc.bge_col0)]
    args = (i32(t_ext), i32(o_feed), jnp.asarray(S), *scal)
    kw = dict(L=L, NoP=NoP, is_int=True, use_matrix=False)
    fz = functools.partial(nw_jax._align_fused, **kw)
    np.asarray(fz(*args, i32(n + 1), i32(n + 1))[1])
    K = 8
    t0 = time.perf_counter()
    outs = [fz(*args, i32(n + 1), i32(n + 1)) for _ in range(K)]
    np.asarray(outs[-1][1])
    thr = ((n + 1) * (n + 1)) / ((time.perf_counter() - t0) / K) / 1e9

    # raw fill compute rate: the pointer tensor reduced to a checksum on
    # device, so neither the traceback nor the download is measured
    @jax.jit
    def fill_sum(*a):
        return jnp.sum(nw_jax._fill_scan(*a, **kw).astype(jnp.int32))

    np.asarray(fill_sum(*args))
    t0 = time.perf_counter()
    for _ in range(K):
        s = fill_sum(*args)
    np.asarray(s)
    raw = ((n + 1) * (n + 1)) / ((time.perf_counter() - t0) / K) / 1e9
    return lat, thr, raw


def grid_sweep_metric(pages, ocrs):
    """Secondary metric: the reference's 729-combination scoring grid
    search (evaluate_text_alignment.py:181-189) — NW stage only — as
    batched lock-step wavefront dispatches (align.api.align_grid), on the bench
    folio's chant-sized pair and on a prev-folio-prepended-sized pair
    (parse_cantus_csv.py:109-117 doubles transcripts in production)."""
    import random
    from text_alignment_tpu.align.api import align_grid
    from text_alignment_tpu.evaluate import scoring_grid
    from text_alignment_tpu.pipeline.assemble import expand_abbreviations

    params = scoring_grid()
    chars = expand_abbreviations(list(ocrs[1]))
    ocr = "".join(c.char for c in chars)
    tra = list(pages[1].transcript)
    rng = random.Random(0)
    big_t = [rng.choice("abcdefgh ") for _ in range(2400)]
    big_o = [rng.choice("abcdefgh ") for _ in range(2400)]
    for label, t, o in (("chant page", tra, list(ocr)),
                        ("2400^2 stress", big_t, big_o)):
        align_grid(t, o, params[:128])  # warm the chunk program
        dt = float("inf")  # best of 2
        for _ in range(2):
            t0 = time.perf_counter()
            align_grid(t, o, params)
            dt = min(dt, time.perf_counter() - t0)
        print(f"# scoring grid sweep ({label}, {len(t)}x{len(o)}): "
              f"729 alignments in {dt:.2f}s = {729/dt:.0f} combos/s",
              file=sys.stderr)


def device_raster_metric(pages):
    """Secondary metric: the device raster's two CC programs on a bench
    page (ops.raster_device, run-graph CC): program A (clean + skew +
    rotate + erode + project) and program B (separator-masked CC table).
    Best of 3 over K back-to-back executions each."""
    import jax.numpy as jnp
    from text_alignment_tpu.ops import cc_runs, oracle, raster_device

    img = oracle.to_onebit(pages[1].image)
    H, W = img.shape
    fa, _ = raster_device._jit_raster_page(H, W, -6.0, 6.0, cc_runs.MAX_RUNS)
    fb = raster_device._jit_masked_cc_table(4096, cc_runs.MAX_RUNS)
    a_args = (jnp.asarray(raster_device.pack_page(img)), jnp.int32(100),
              jnp.int32(150))
    eroded = fa(*a_args)[1]
    b_args = (eroded, jnp.zeros(eroded.shape[0], bool), jnp.int32(100))
    K = 5
    for name, fn, args in (("A", fa, a_args), ("B", fb, b_args)):
        np.asarray(fn(*args)[-1])
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(K - 1):
                fn(*args)
            np.asarray(fn(*args)[-1])
            best = min(best, (time.perf_counter() - t0) / K)
        print(f"# device raster program {name} ({H}x{W} page): "
              f"{best*1e3:.2f} ms", file=sys.stderr)


def train_metric():
    """Secondary metric: CTC training throughput — the ocropus-rtrain
    equivalent (reference README.md:52-56). The reference's only published
    training number is ~12 h of CPU for the Salzinnes model's 54,500
    single-line iterations (.MISSING_LARGE_BLOBS:1-2) ~= 1.26
    line-updates/s. Measures the jitted batched train step (BiLSTM forward
    + CTC loss + backward + clipped Adam update) at a realistic line shape,
    params/opt-state threaded on device so K steps fence once."""
    import jax.numpy as jnp
    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.models.train import Trainer

    codec = Codec()
    tr = Trainer(codec=codec)
    rng = np.random.default_rng(3)
    B, T, S = 128, 512, 48
    xs = (rng.random((B, T, 48)) < 0.1).astype(np.float32)
    args = (jnp.asarray(xs), jnp.full(B, T, jnp.int32),
            jnp.asarray(rng.integers(1, len(codec), (B, S)), jnp.int32),
            jnp.full(B, S, jnp.int32), jnp.asarray(0.0, jnp.float32))
    t0 = time.perf_counter()
    p, o, loss = tr._step(tr.params, tr.opt_state, *args)
    float(loss)
    warm = time.perf_counter() - t0
    K = 20
    t0 = time.perf_counter()
    for _ in range(K):
        p, o, loss = tr._step(p, o, *args)
    float(loss)
    dt = (time.perf_counter() - t0) / K
    ref_rate = 54500 / (12 * 3600.0)
    print(f"# train step (B={B}, T={T}, ni=48, ns=100): {dt*1e3:.1f} ms/step "
          f"= {B/dt:.0f} line-updates/s (warmup {warm:.1f}s; reference "
          f"ocropus-rtrain ~{ref_rate:.2f} lines/s CPU -> the 54,500-iter "
          f"Salzinnes workload is ~{54500/(B/dt):.0f}s of step compute)",
          file=sys.stderr)


def main():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py measures the GPU path; JAX found no GPU "
                 f"(default platform: {platform})")
    from text_alignment_tpu.ops import host_native

    # the hybrid raster IS the native engine: never time the numpy oracle
    # under its name
    if DEVICE_BACKEND == "hybrid" and not host_native.available():
        sys.exit(f"bench.py measures the hybrid path, whose raster is the "
                 f"native engine; it did not load: "
                 f"{host_native.load_error()}")

    from text_alignment_tpu import ensure_compile_cache
    from text_alignment_tpu.utils.timing import compile_log_capture

    ensure_compile_cache()  # persistent XLA cache (accelerator backends only)
    print(f"# device: {platform} {jax.devices()[0].device_kind} x"
          f"{len(jax.devices())}", file=sys.stderr)

    NF = N_DEVICE_FOLIOS
    from text_alignment_tpu.synth import bench_page

    pages = [bench_page(BENCH_SEED + i) for i in range(NF + 1)]
    ocrs = [injected_ocr(p, 77 + i) for i, p in enumerate(pages)]

    dev_rec = device_recognizer()

    # warmup/compile on folio 0, with per-program compile attribution so the
    # cold-start cost has visible levers
    t0 = time.perf_counter()
    with compile_log_capture() as cold:
        folio_flow(pages[0], ocrs[0], dev_rec, backend=DEVICE_BACKEND)
    warm_wall = time.perf_counter() - t0
    print(f"# device[{DEVICE_BACKEND}] warmup (incl. compile): {warm_wall:.1f}s",
          file=sys.stderr)
    print(f"# warmup compile breakdown: {cold.report()}", file=sys.stderr)
    # second warmup pass: the first pass learned the recognizer's frame
    # bucket hint, so production folios dispatch a DIFFERENT (hint-sized)
    # program — load it now rather than inside the timed loop
    t0 = time.perf_counter()
    folio_flow(pages[0], ocrs[0], dev_rec, backend=DEVICE_BACKEND)
    print(f"# hint-shape warmup pass: {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    # rung-warming lap: per-folio OCR dispatches are shaped by each folio's
    # pack-ladder rungs (Hp, Wp, t_max), so a folio with a novel rung
    # triggers a one-time compile. Steady-state
    # serving has all rungs resident after the first few folios of a
    # manuscript; warm them here so the timed laps measure that steady
    # state (cold cost stays visible in the warmup lines above).
    t0 = time.perf_counter()
    with compile_log_capture() as cold_r:
        for i in range(1, NF + 1):
            folio_flow(pages[i], ocrs[i], dev_rec, backend=DEVICE_BACKEND)
    print(f"# rung-warming lap ({time.perf_counter()-t0:.1f}s wall): "
          f"{cold_r.report() if cold_r.entries else 'no new programs'}",
          file=sys.stderr)

    t0 = time.perf_counter()
    for i in range(1, NF + 1):
        folio_flow(pages[i], ocrs[i], dev_rec, backend=DEVICE_BACKEND)
    seq_dt = (time.perf_counter() - t0) / NF
    print(f"# device[{DEVICE_BACKEND}] sequential: {seq_dt*1e3:.0f} ms/folio",
          file=sys.stderr)

    # batched stage-major pipeline (the production throughput path):
    # cross-folio OCR batching + bucket-vmapped NW. Same work content as
    # folio_flow: full raster + line id per folio, one recognizer sweep
    # over every strip, alignment on the injected realistic OCR streams.
    from text_alignment_tpu.parallel.batch import process_batch
    from text_alignment_tpu.pipeline.preprocess import (
        preprocess_images,
        raster_stream,
        identify_text_lines,
    )

    folios = [(p.image, p.transcript) for p in pages[1:]]
    inj = ocrs[1 : NF + 1]

    def batched_flow():
        # the SAME background OCR worker process_batch's pipelined branch
        # uses (parallel.batch.PipelinedOCRWorker — shared so the bench can
        # never drift from the production pipeline): each folio's strips
        # dispatch as they raster (upload hidden under raster) with chunked
        # combined downloads; alignment then runs on the injected realistic
        # OCR streams (weights are untrained)
        from text_alignment_tpu.parallel.batch import PipelinedOCRWorker

        nb = len(pages) - 1
        pre = []
        worker = (PipelinedOCRWorker(dev_rec, nb)
                  if getattr(dev_rec, "normalize_on_device", False)
                  else None)
        try:
            # raster_stream = the production raster: run-domain hybrid
            # fast path, and on accelerators each folio's skew search
            # runs as a grouped async device dispatch hidden under the
            # next folios' host raster
            stream = raster_stream(
                [p.image for p in pages[1:]], backend=DEVICE_BACKEND
            )
            for image, angle, strips, peaks in stream:
                pre.append((image, angle, strips, peaks))
                if worker is not None:
                    worker.put([s.img for s in strips])
                else:
                    dev_rec.recognize_batch([s.img for s in strips])
        finally:
            if worker is not None:
                worker.abandon()
        if worker is not None:
            worker.rows()
        return process_batch(folios, None, backend=DEVICE_BACKEND,
                             existing_ocr=inj, existing_pre=pre)

    t0 = time.perf_counter()
    with compile_log_capture() as cold_b:
        batched_flow()  # warm the batch-size jit cache entries
    if cold_b.entries:
        print(f"# batched-path extra compiles "
              f"({time.perf_counter()-t0:.1f}s wall): {cold_b.report()}",
              file=sys.stderr)
    # best of 3: host timings are noisy; best-of is the convention for
    # every other metric here
    dev_dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        results = batched_flow()
        dev_dt = min(dev_dt, (time.perf_counter() - t0) / NF)
    assert sum(r is not None for r in results) == len(folios)
    print(f"# device[{DEVICE_BACKEND}] batched: {dev_dt*1e3:.0f} ms/folio "
          f"(best of 3)", file=sys.stderr)

    # CPU baseline: host oracle pipeline + reference NW + numpy LSTM
    base_rec = baseline_recognizer()
    import text_alignment_tpu.pipeline.process as proc_mod
    from text_alignment_tpu.align import api as align_api

    orig = align_api.perform_alignment

    def ref_nw_alignment(t, o, scoring_system=None, verbose=False, backend="auto"):
        return orig(t, o, scoring_system=scoring_system, verbose=verbose,
                    backend="reference")

    # fixed folio set: baseline samples run the SAME pages the device batch
    # measures (pages 1..N_BASELINE_FOLIOS), so the ratio compares identical
    # work; median over >= 5 samples tames host-timing noise
    times = []
    NB = min(N_BASELINE_FOLIOS, NF)
    proc_mod.perform_alignment = ref_nw_alignment
    try:
        for i in range(1, NB + 1):
            t0 = time.perf_counter()
            folio_flow(pages[i], ocrs[i], base_rec, backend="host")
            times.append(time.perf_counter() - t0)
    finally:
        proc_mod.perform_alignment = orig
    base_dt = float(np.median(times))
    print(f"# cpu baseline: {base_dt*1e3:.0f} ms/folio "
          f"(median of {NB}: "
          f"{['%.1fs' % t for t in times]})", file=sys.stderr)
    print(f"# absolute: batched {dev_dt*1e3:.1f} ms/folio, "
          f"sequential {seq_dt*1e3:.1f} ms/folio, "
          f"baseline {base_dt*1e3:.0f} ms/folio", file=sys.stderr)

    ocr_metrics(pages, dev_rec)
    device_raster_metric(pages)
    grid_sweep_metric(pages, ocrs)
    train_metric()
    lat8, thr8, raw8 = nw_gcups_stress(8191)
    lat16, thr16, raw16 = nw_gcups_stress(16383)
    print(f"# nw fused fill+traceback: {lat8:.2f} GCUPS @ 8192x8192, "
          f"{lat16:.2f} GCUPS @ 16384x16384 (single-shot incl. download)",
          file=sys.stderr)
    print(f"# nw pipelined throughput (depth 8): {thr8:.2f} GCUPS @ "
          f"8192x8192, {thr16:.2f} GCUPS @ 16384x16384", file=sys.stderr)
    print(f"# nw raw fill compute (no traceback/download): "
          f"{raw8:.2f} GCUPS @ 8192x8192, {raw16:.2f} GCUPS @ "
          f"16384x16384", file=sys.stderr)

    folios_per_sec = 1.0 / dev_dt
    vs_baseline = base_dt / dev_dt
    print(json.dumps({
        "metric": "folios/sec",
        "value": round(folios_per_sec, 3),
        "unit": "folios/sec",
        "vs_baseline": round(vs_baseline, 2),
    }))


if __name__ == "__main__":
    main()
