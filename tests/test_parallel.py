"""Mesh/sharded training + batched folio pipeline tests (8-device CPU mesh)."""

import numpy as np
import pytest
import jax

from text_alignment_tpu.parallel import (
    make_mesh,
    data_model_mesh,
    sharded_train_demo_step,
)
from text_alignment_tpu.parallel.batch import process_batch
from text_alignment_tpu.pipeline import process, to_JSON_dict
from text_alignment_tpu.pipeline.preprocess import PreprocParams
from text_alignment_tpu.synth import make_page, corrupt_ocr, ocr_with_spaces
from text_alignment_tpu.pipeline.assemble import to_processed_frame
from text_alignment_tpu.pipeline.preprocess import preprocess_images

SYNTH_PARAMS = PreprocParams(filter_size=8)


def test_mesh_construction():
    m = make_mesh(8)
    assert m.shape == {"data": 8}
    m2 = data_model_mesh(8)
    assert m2.shape == {"data": 4, "model": 2}
    m3 = data_model_mesh(8, model_parallel=1)
    assert m3.shape == {"data": 8, "model": 1}


def test_sharded_train_step_runs():
    mesh = data_model_mesh(8)
    loss = sharded_train_demo_step(mesh)
    assert np.isfinite(loss)


def test_sharded_matches_single_device():
    """DP+TP sharding must not change the math: one step on an 8-device
    mesh equals one step on a 1-device mesh."""
    # same global batch (8) on both meshes
    l8 = sharded_train_demo_step(data_model_mesh(8), batch_per_device=2, seed=3)
    l1 = sharded_train_demo_step(data_model_mesh(1), batch_per_device=8, seed=3)
    assert l8 == pytest.approx(l1, rel=1e-5)


def test_process_batch_matches_sequential():
    rng = np.random.default_rng(21)
    folios = []
    injected = []
    for i in range(3):
        page = make_page(np.random.default_rng(30 + i), n_lines=4,
                         words_per_line=2)
        ocr = ocr_with_spaces(corrupt_ocr(rng, page.char_boxes))
        image, eroded, angle = preprocess_images(page.image, backend="host")
        lifted = [
            to_processed_frame(cb, angle, image.shape, page.image.shape)
            for cb in ocr
        ]
        folios.append((page.image, page.transcript))
        injected.append(lifted)

    batch_results = process_batch(
        folios, recognizer=None, backend="host",
        preproc_params=SYNTH_PARAMS, existing_ocr=injected,
    )
    for (raw, transcript), inj, br in zip(folios, injected, batch_results):
        seq = process(raw, transcript, existing_ocr=inj, verbose=False,
                      backend="host", preproc_params=SYNTH_PARAMS)
        assert br is not None
        assert to_JSON_dict(seq[0], seq[2]) == br.json_dict


def test_process_batch_device_backend():
    rng = np.random.default_rng(22)
    folios = []
    injected = []
    for i in range(2):
        page = make_page(np.random.default_rng(40 + i), n_lines=4,
                         words_per_line=2)
        ocr = ocr_with_spaces(corrupt_ocr(rng, page.char_boxes))
        image, eroded, angle = preprocess_images(page.image, backend="host")
        lifted = [
            to_processed_frame(cb, angle, image.shape, page.image.shape)
            for cb in ocr
        ]
        folios.append((page.image, page.transcript))
        injected.append(lifted)

    host = process_batch(folios, None, backend="host",
                         preproc_params=SYNTH_PARAMS, existing_ocr=injected)
    dev = process_batch(folios, None, backend="device",
                        preproc_params=SYNTH_PARAMS, existing_ocr=injected)
    for h, d in zip(host, dev):
        assert h.json_dict == d.json_dict


def test_sharded_recognizer_matches_single_device():
    """OCR decode is identical whether the strip batch runs on one device
    or sharded over the 8-way mesh (data parallelism, no collectives)."""
    import jax
    import numpy as np
    from text_alignment_tpu.parallel import make_mesh
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.models.recognizer import SeqRecognizer
    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.synth import make_page
    from text_alignment_tpu.pipeline.preprocess import (
        preprocess_images,
        identify_text_lines,
    )

    page = make_page(np.random.default_rng(11), n_lines=4, words_per_line=2,
                     H=700, W=600, char_h=45, char_w=28, gap=5, space_w=35,
                     line_spacing=140, speckles=20, margin_x=25, angle=0.0)
    image, eroded, _ = preprocess_images(page.image, backend="host")
    strips, _, _ = identify_text_lines(image, eroded, backend="host",
                                       verbose=False)
    codec = Codec()
    params = init_bilstm(jax.random.PRNGKey(3), 48, 100, len(codec))
    mesh = make_mesh(8)
    rec1 = SeqRecognizer(params, codec, normalize_on_device=True)
    rec8 = SeqRecognizer(params, codec, normalize_on_device=True, mesh=mesh)
    rows1 = rec1.recognize_batch([s.img for s in strips])
    rows8 = rec8.recognize_batch([s.img for s in strips])
    assert rows1 == rows8


def test_pipelined_ocr_dispatch_matches_sync():
    """process_batch's async per-folio OCR dispatch (device work hidden
    under the next folio's raster) decodes identically to synchronous
    per-folio recognition."""
    import jax
    import numpy as np
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.models.recognizer import SeqRecognizer
    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.synth import make_page
    from text_alignment_tpu.pipeline.preprocess import (
        preprocess_images,
        identify_text_lines,
    )

    codec = Codec()
    params = init_bilstm(jax.random.PRNGKey(7), 48, 100, len(codec))
    rec = SeqRecognizer(params, codec, normalize_on_device=True)

    pages = [
        make_page(np.random.default_rng(20 + i), n_lines=3, words_per_line=2,
                  H=600, W=500, char_h=40, char_w=26, gap=5, space_w=30,
                  line_spacing=140, speckles=10, margin_x=25)
        for i in range(3)
    ]
    handles = []
    per_folio_strips = []
    for p in pages:
        image, eroded, _ = preprocess_images(p.image, backend="host")
        strips, _, _ = identify_text_lines(image, eroded, backend="host",
                                           verbose=False)
        per_folio_strips.append(strips)
        handles.append(rec.dispatch_async([s.img for s in strips]))
    rows_async = rec.collect_async(handles)
    for strips, rows in zip(per_folio_strips, rows_async):
        assert rows == rec.recognize_batch([s.img for s in strips])


def test_sharded_folio_pipeline_byte_identical():
    """The FULL sharded folio pipeline (threaded raster + mesh-sharded OCR
    + mesh-sharded NW buckets) emits byte-identical JSON to the
    single-device process_batch — the Rodan fan-out analog, proven on the
    8-way virtual CPU mesh."""
    import json
    import jax
    from text_alignment_tpu.parallel import make_mesh
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.models.recognizer import SeqRecognizer
    from text_alignment_tpu.models.codec import Codec

    codec = Codec()
    params = init_bilstm(jax.random.PRNGKey(5), 48, 100, len(codec))
    rec = SeqRecognizer(params, codec, normalize_on_device=True)

    folios = []
    for i in range(3):
        page = make_page(np.random.default_rng(60 + i), n_lines=4,
                         words_per_line=2)
        folios.append((page.image, page.transcript))

    single = process_batch(folios, rec, backend="device",
                           preproc_params=SYNTH_PARAMS)
    mesh = make_mesh(8)
    sharded = process_batch(folios, rec, backend="device",
                            preproc_params=SYNTH_PARAMS, mesh=mesh,
                            min_align_device_cells=0)
    assert rec.mesh is None  # caller's recognizer must not be mutated
    assert any(s is not None for s in single)  # not vacuous
    for s, m in zip(single, sharded):
        if s is None:
            assert m is None
            continue
        assert json.dumps(s.json_dict, sort_keys=True) == \
            json.dumps(m.json_dict, sort_keys=True)


def test_chunked_bg_collect_matches_single_collect():
    """collect_async_bg (the download-overlap thread) + a second collect
    must decode identically to one combined collect of all handles."""
    import jax
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.models.recognizer import SeqRecognizer
    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.synth import make_page
    from text_alignment_tpu.pipeline.preprocess import (
        preprocess_images,
        identify_text_lines,
    )

    codec = Codec()
    params = init_bilstm(jax.random.PRNGKey(7), 48, 100, len(codec))
    rec = SeqRecognizer(params, codec, normalize_on_device=True)
    handles = []
    for i in range(6):
        p = make_page(np.random.default_rng(40 + i), n_lines=2,
                      words_per_line=2, H=500, W=460, char_h=40, char_w=26,
                      gap=5, space_w=30, line_spacing=140, speckles=10,
                      margin_x=25)
        image, eroded, _ = preprocess_images(p.image, backend="host")
        strips, _, _ = identify_text_lines(image, eroded, backend="host",
                                           verbose=False)
        handles.append(rec.dispatch_async([s.img for s in strips]))
    join = rec.collect_async_bg(handles[:3])
    chunked = join() + rec.collect_async(handles[3:])
    combined = rec.collect_async(handles)
    assert chunked == combined


def test_process_batch_pipelined_chunked_matches_process():
    """6-folio process_batch (pipelined + chunked bg collect engaged)
    produces JSON byte-identical to per-folio pipeline.process with the
    same recognizer."""
    import json
    import jax
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.models.recognizer import SeqRecognizer
    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.synth import make_page
    from text_alignment_tpu.pipeline import process, to_JSON_dict

    codec = Codec()
    params = init_bilstm(jax.random.PRNGKey(7), 48, 100, len(codec))
    rec = SeqRecognizer(params, codec, normalize_on_device=True)
    pages = [
        make_page(np.random.default_rng(50 + i), n_lines=2, words_per_line=2,
                  H=500, W=460, char_h=40, char_w=26, gap=5, space_w=30,
                  line_spacing=140, speckles=10, margin_x=25)
        for i in range(6)
    ]
    folios = [(p.image, p.transcript) for p in pages]
    batch = process_batch(folios, rec, backend="host")
    for (img, tr), r in zip(folios, batch):
        seq = process(img, tr, ocropus_model=rec, verbose=False,
                      backend="host")
        if seq is None or r is None:
            assert seq is None and r is None
            continue
        syl_boxes, _, peaks, _ = seq
        assert json.dumps(r.json_dict, sort_keys=True) == \
               json.dumps(to_JSON_dict(syl_boxes, peaks), sort_keys=True)


def test_abandoned_ocr_worker_skips_downloads():
    """abandon() must CANCEL the doomed batch's device work, not just
    unblock the loop: no further dispatches, and no result downloads
    (they would queue ahead of the next batch's work). rows() raises for
    the doomed batch."""
    import pytest
    from text_alignment_tpu.parallel.batch import PipelinedOCRWorker

    class StubRec:
        def __init__(self):
            self.dispatched = 0
            self.collected = 0

        def dispatch_async(self, strips):
            self.dispatched += 1
            return strips

        def collect_async(self, handles):
            self.collected += 1
            return [[] for _ in handles]

        def collect_async_bg(self, handles):
            self.collected += 1
            return lambda: [[] for _ in handles]

    rec = StubRec()
    w = PipelinedOCRWorker(rec, 8)
    w.put([])  # one folio rastered, then the batch dies
    w.abandon()
    with pytest.raises(RuntimeError, match="abandoned"):
        w.rows()
    assert rec.collected == 0
    assert rec.dispatched <= 1

    # and a fully-enqueued batch is NOT cancelled by the finally-abandon
    rec2 = StubRec()
    w2 = PipelinedOCRWorker(rec2, 3)
    for _ in range(3):
        w2.put([])
    w2.abandon()  # no-op
    assert w2.rows() == [[], [], []]


def test_raster_failure_does_not_strand_ocr_worker():
    """A raster exception mid-batch must propagate AND terminate the
    background OCR worker (it loops exactly n times on the strip queue;
    without the sentinel feed a long-lived serve process would leak one
    blocked thread per failed batch)."""
    import threading
    import time

    import jax
    import pytest
    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.models.recognizer import SeqRecognizer
    from text_alignment_tpu.parallel.batch import process_batch

    codec = Codec()
    rec = SeqRecognizer(init_bilstm(jax.random.PRNGKey(0), 48, 8, len(codec)),
                        codec, normalize_on_device=True)
    before = set(threading.enumerate())
    bad = np.zeros((40, 30, 2), np.uint8)  # 2 channels: raster rejects it
    with pytest.raises(ValueError):
        process_batch([(bad, "a"), (bad, "b"), (bad, "c")], rec,
                      backend="host")
    deadline = time.time() + 30.0
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t not in before and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"OCR worker thread(s) leaked: {leaked}"


def test_sharded_ocr_work_partition():
    """The sharded OCR dispatch must PARTITION the strip batch across the
    mesh (one equal shard per device — not replicate), certified by
    recognize_sharded_meta and recorded in LAST_WORK_SHARES."""
    import jax
    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.parallel import infer_dp, make_mesh

    codec = Codec()
    params = init_bilstm(jax.random.PRNGKey(0), 48, 100, len(codec))
    rng = np.random.default_rng(0)
    for n_dev, B in ((1, 8), (8, 16)):
        mesh = make_mesh(n_dev)
        bits = rng.integers(0, 2**31, (B, 129, 8)).astype(np.int32)
        bits[:, -1, 0] = 60
        bits[:, -1, 1] = 200
        infer_dp.recognize_sharded_meta(
            params, bits, mesh, t_max=256, target_height=48, pad=16,
            max_regions=64)
        shares = dict(infer_dp.LAST_WORK_SHARES)
        assert len(shares) == n_dev
        assert set(shares.values()) == {B // n_dev}


def test_sharded_grid_matches_single_device():
    """align_grid(mesh=...) partitions the scoring-parameter axis over
    'data' and returns bit-identical alignments (incl. a combo count that
    does not divide the axis — pad rows discarded)."""
    from text_alignment_tpu.align.api import align_grid
    from text_alignment_tpu.parallel import make_mesh

    t = list("gloria in excelsis deo")
    o = list("gloia inn xcelsis dho")
    grid = [[8, -4, -7, -7, -3, 0], [5, -4, -2, -2, 0, 0],
            [11, -10, -7, -7, -5, -5], [8, -7, -5, -2, -3, 0],
            [5, -7, -7, -5, 0, -3]]  # 5 combos over 8 devices
    got = align_grid(t, o, grid, mesh=make_mesh(8))
    want = align_grid(t, o, grid)
    assert got == want
