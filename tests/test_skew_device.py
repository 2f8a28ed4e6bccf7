"""Device-offloaded skew search (ops.skew_device) vs the host oracle.

The accelerator search must be bit-identical to
oracle.rotation_angle_projections / host_native.rotation_angle_projections
(reference semantics: Gamera rotation_angle_projections(-6, 6),
textAlignPreprocessing.py:183): same Q16 shift grids, same exact integer
squared-derivative criterion, same first-max tie rule, same coarse-to-fine
recipe. On CPU JAX (this suite) the program lowers to the same integer
formulas, so parity here transfers to the GPU (re-checked on the card by
tests/test_gpu_hw.py).
"""

import json
import os

import numpy as np
import pytest

from text_alignment_tpu.ops import oracle, skew_device


def _lined_page(rng, H, W, angle_deg):
    """Synthetic page with line structure sloped like a rotation."""
    page = np.zeros((H, W), bool)
    t = np.tan(np.radians(angle_deg))
    for y0 in range(10, H - 5, max(8, H // 8)):
        xs = rng.integers(0, W, size=max(10, W // 2))
        ys = (y0 + t * (xs - W // 2)).astype(int)
        ok = (ys >= 0) & (ys < H)
        page[ys[ok], xs[ok]] = True
    page[rng.integers(0, H, 30), rng.integers(0, W, 30)] = True
    return page


def test_device_skew_matches_oracle_fuzz():
    rng = np.random.default_rng(42)
    for _ in range(8):
        H = int(rng.integers(40, 500))
        W = int(rng.integers(40, 600))
        page = _lined_page(rng, H, W, float(rng.uniform(-5.5, 5.5)))
        a_host = oracle.rotation_angle_projections(page, -6, 6)
        a_dev = skew_device.rotation_angle_projections(page, -6, 6)
        assert a_dev == a_host


def test_device_skew_wide_sharp_edge_exact():
    """Adjacent-row projection diffs beyond 4096 (a near-full-width ink
    band on a wide page) must still score exactly: the squared term is
    computed in int32 AFTER the cast — an f32 d*d rounds once |d| > 4096
    and would silently break bit-parity with the host criterion."""
    rng = np.random.default_rng(11)
    page = np.zeros((64, 5000), bool)
    page[20:33, 100:4900] = True  # |d| = 4800 at the band edges
    page[rng.integers(0, 64, 200), rng.integers(0, 5000, 200)] = True
    a_host = oracle.rotation_angle_projections(page, -6, 6)
    a_dev = skew_device.rotation_angle_projections(page, -6, 6)
    assert a_dev == a_host


def test_device_skew_blank_and_tiny_pages():
    blank = np.zeros((64, 80), bool)
    assert (skew_device.rotation_angle_projections(blank)
            == oracle.rotation_angle_projections(blank))
    tiny = np.zeros((3, 130), bool)
    tiny[1, ::2] = True
    assert (skew_device.rotation_angle_projections(tiny)
            == oracle.rotation_angle_projections(tiny))


def test_tan_tree_covers_recipe_and_indices_roundtrip():
    """Every index triple the device can emit maps to the angle the host
    recipe would have produced for those per-round winners."""
    from text_alignment_tpu.ops import fixedpoint as fxp

    t1, t2, t3 = skew_device._tan_tree(-6.0, 6.0)
    c1 = fxp.angle_grid(-6.0, 6.0, 1.0)
    assert t1.shape == (len(c1),) and t2.shape == (len(c1), 19)
    assert t3.shape == (len(c1), 19, 19)
    rng = np.random.default_rng(0)
    for _ in range(20):
        i1 = int(rng.integers(len(c1)))
        i2 = int(rng.integers(19))
        i3 = int(rng.integers(19))
        b1 = c1[i1]
        c2 = fxp.angle_grid(b1 - 0.9, b1 + 0.9, 0.1)
        b2 = c2[i2]
        c3 = fxp.angle_grid(b2 - 0.09, b2 + 0.09, 0.01)
        assert skew_device.angle_from_indices(i1, i2, i3) == float(c3[i3])
        # the stored tangents are the exact fxp Q16 quantization
        assert t2[i1, i2] == skew_device._qtan(b2)
        assert t3[i1, i2, i3] == skew_device._qtan(c3[i3])


def test_grouped_worker_matches_oracle_and_pads_partial_groups():
    rng = np.random.default_rng(7)
    pages = [
        _lined_page(rng, int(rng.integers(60, 300)),
                    int(rng.integers(60, 400)), float(rng.uniform(-4, 4)))
        for _ in range(5)  # 5 pages of distinct shapes: every group partial
    ]
    w = skew_device.GroupedSkewWorker(group=2)
    slots = [w.put(p.astype(np.uint8)) for p in pages]
    w.finish()
    w.finish()  # idempotent
    for p, s in zip(pages, slots):
        assert w.angle(s) == oracle.rotation_angle_projections(p, -6, 6)


def test_preprocess_stream_device_skew_bit_identical(monkeypatch):
    monkeypatch.setenv("TEXT_ALIGNMENT_TPU_SKEW", "device")
    from text_alignment_tpu.synth import make_page
    from text_alignment_tpu.pipeline.preprocess import (
        preprocess_images,
        preprocess_stream,
    )

    pages = [
        make_page(np.random.default_rng(100 + i), n_lines=3,
                  words_per_line=2).image
        for i in range(6)  # 6 = one full group of 4 + a padded partial
    ]
    ref = [preprocess_images(p, backend="hybrid") for p in pages]
    got = list(preprocess_stream(pages, backend="hybrid", skew="device"))
    assert len(got) == len(ref)
    for (ib, ie, a), (rb, re_, ra) in zip(got, ref):
        assert a == ra
        assert np.array_equal(ib, rb) and np.array_equal(ie, re_)


def test_process_batch_device_skew_json_identical(monkeypatch):
    import jax

    from text_alignment_tpu.synth import make_page
    from text_alignment_tpu.parallel.batch import process_batch
    from text_alignment_tpu.models.recognizer import SeqRecognizer
    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.models.lstm_jax import init_bilstm

    codec = Codec()
    params = init_bilstm(jax.random.PRNGKey(3), 48, 100, len(codec))
    rec = SeqRecognizer(params, codec, normalize_on_device=True)
    pages = [
        make_page(np.random.default_rng(200 + i), n_lines=3,
                  words_per_line=2)
        for i in range(5)
    ]
    folios = [(p.image, p.transcript) for p in pages]
    monkeypatch.setenv("TEXT_ALIGNMENT_TPU_SKEW", "host")
    a = process_batch(folios, rec, backend="hybrid")
    monkeypatch.setenv("TEXT_ALIGNMENT_TPU_SKEW", "device")
    b = process_batch(folios, rec, backend="hybrid")
    for x, y in zip(a, b):
        ja = None if x is None else json.dumps(x.json_dict, sort_keys=True)
        jb = None if y is None else json.dumps(y.json_dict, sort_keys=True)
        assert ja == jb


def test_preprocess_stream_diverse_geometry_no_deadlock(monkeypatch):
    """Regression: 12 pages of pairwise-distinct padded geometries. Every
    (Hp, Wp) bucket holds a partial group, so the stream's lookahead can
    never fill one — GroupedSkewWorker.angle() must dispatch the blocked
    slot's partial group itself or the generator deadlocks (angle() blocks
    before finish() is reachable)."""
    import threading

    monkeypatch.setenv("TEXT_ALIGNMENT_TPU_SKEW", "device")
    from text_alignment_tpu.synth import make_page
    from text_alignment_tpu.pipeline.preprocess import (
        preprocess_images,
        preprocess_stream,
    )

    pages = [
        make_page(np.random.default_rng(400 + i), n_lines=2,
                  words_per_line=2, H=220 + 32 * i, W=260 + 130 * i).image
        for i in range(12)
    ]
    got = []
    t = threading.Thread(
        target=lambda: got.extend(
            preprocess_stream(pages, backend="hybrid", skew="device")),
        daemon=True,
    )
    t.start()
    t.join(timeout=300)
    assert not t.is_alive(), (
        "preprocess_stream deadlocked on diverse page geometries "
        f"(yielded {len(got)}/{len(pages)})"
    )
    assert len(got) == len(pages)
    for p, (ib, ie, a) in zip(pages, got):
        rb, re_, ra = preprocess_images(p, backend="hybrid")
        assert a == ra
        assert np.array_equal(ib, rb) and np.array_equal(ie, re_)


def test_stream_abandon_terminates_collector():
    """Closing the generator mid-stream must not leak the collector
    thread (long-lived serve processes raster many batches)."""
    import threading

    os.environ["TEXT_ALIGNMENT_TPU_SKEW"] = "device"
    try:
        from text_alignment_tpu.synth import make_page
        from text_alignment_tpu.pipeline.preprocess import preprocess_stream

        pages = [
            make_page(np.random.default_rng(300 + i), n_lines=2,
                      words_per_line=2).image
            for i in range(4)
        ]
        before = threading.active_count()
        stream = preprocess_stream(pages, backend="hybrid", skew="device")
        next(stream)
        stream.close()
        import time

        for _ in range(100):
            if threading.active_count() <= before:
                break
            time.sleep(0.05)
        assert threading.active_count() <= before
    finally:
        os.environ.pop("TEXT_ALIGNMENT_TPU_SKEW", None)


def test_serve_warmup_batch_precompiles_grouped_skew(monkeypatch):
    """serve --warmup with batch > 1 must pre-run the grouped device-skew
    program (the batched pipeline's raster path) without error."""
    monkeypatch.setenv("TEXT_ALIGNMENT_TPU_SKEW", "device")
    from text_alignment_tpu.serve import warmup

    warmup(None, "hybrid", batch=2)


def test_raster_stream_device_skew_bit_identical(monkeypatch):
    """The fused run-domain raster_stream with the device skew search
    (GroupedSkewWorker.put_runs packing bits straight from phase-1 runs)
    matches the sequential hybrid composition exactly."""
    monkeypatch.setenv("TEXT_ALIGNMENT_TPU_SKEW", "device")
    from text_alignment_tpu.synth import make_page
    from text_alignment_tpu.pipeline.preprocess import (
        identify_text_lines,
        preprocess_images,
        raster_stream,
    )

    pages = [
        make_page(np.random.default_rng(100 + i), n_lines=3,
                  words_per_line=2, angle=(0.0, 0.7, -1.3, 0.2, 2.1, -0.4)[i]
                  ).image
        for i in range(6)  # one full group of 4 + a padded partial
    ]
    got = list(raster_stream(pages, backend="hybrid", skew="device"))
    assert len(got) == len(pages)
    for p, (ib2, ang2, strips2, peaks2) in zip(pages, got):
        ib, ie, ang = preprocess_images(p, backend="hybrid")
        strips, peaks, _ = identify_text_lines(ib, ie, backend="hybrid",
                                               verbose=False)
        assert ang == ang2
        assert np.array_equal(np.asarray(ib), np.asarray(ib2))
        assert list(peaks) == list(peaks2)
        assert len(strips) == len(strips2)
        for a, b in zip(strips, strips2):
            assert (a.offset_x, a.offset_y) == (b.offset_x, b.offset_y)
            assert np.array_equal(a.img, b.img)
