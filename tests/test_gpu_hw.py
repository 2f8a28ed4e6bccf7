"""On-GPU parity lane: the XLA paths on the card vs the host oracles.

Every test here is marked ``gpu`` and takes the ``gpu`` fixture, so it
skips without a card. On a machine with one:

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_hw.py -q

(``python chip_smoke.py`` runs this lane as one of its phases). Every f32
product on these paths asks for ``Precision.HIGHEST``, which on the GPU is
full f32, not TF32; the tolerances below assume that.
"""

import random

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _bench_strips(n_pages=12):
    from text_alignment_tpu.pipeline.preprocess import (
        identify_text_lines,
        preprocess_images,
    )
    from text_alignment_tpu.synth import bench_page

    strips = []
    for i in range(n_pages):
        page = bench_page(1235 + i)
        image, eroded, _ = preprocess_images(page.image, backend="hybrid")
        ls, _, _ = identify_text_lines(image, eroded, backend="hybrid",
                                       verbose=False)
        strips.extend(np.asarray(s.img) for s in ls)
    return strips


def test_bilstm_matches_numpy_reference(gpu):
    """BiLSTM posteriors at the recognizer's full width (ni=48, ns=100)
    and the sweep's batch (B=128, T=2048) vs the numpy oracle: max abs
    difference <= 1e-5 on every valid frame (f32 at HIGHEST; the oracle
    runs line by line, checked on 16 lines of the batch)."""
    import jax
    import jax.numpy as jnp

    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.models.lstm_jax import (
        bilstm_forward_batched,
        init_bilstm,
        params_to_np,
    )
    from text_alignment_tpu.models.lstm_np import bilstm_forward_np

    B, T, ni, ns = 128, 2048, 48, 100
    params = init_bilstm(jax.random.PRNGKey(3), ni, ns, len(Codec()))
    rng = np.random.default_rng(4)
    xs = rng.random((B, T, ni)).astype(np.float32)
    lengths = rng.integers(T // 4, T + 1, B).astype(np.int32)
    lengths[0] = T
    out = np.asarray(bilstm_forward_batched(params, jnp.asarray(xs),
                                            jnp.asarray(lengths)))
    d = params_to_np(params)
    for b in range(0, B, B // 16):
        L = int(lengths[b])
        ref = bilstm_forward_np(d, xs[b, :L])
        assert np.abs(out[b, :L] - ref).max() <= 1e-5, b


def test_fused_ocr_decode_matches_host_normalize(gpu):
    """The 121-strip cross-folio sweep through the fused device OCR
    program (bit-packed upload -> device normalize -> BiLSTM -> CTC)
    decodes the same character strings as the scipy normalizer feeding
    the same net."""
    import jax

    from text_alignment_tpu.models.codec import Codec
    from text_alignment_tpu.models.lstm_jax import init_bilstm
    from text_alignment_tpu.models.recognizer import SeqRecognizer

    strips = _bench_strips()
    assert len(strips) >= 100, len(strips)
    codec = Codec()
    params = init_bilstm(jax.random.PRNGKey(0), 48, 100, len(codec))
    rows_h = SeqRecognizer(params, codec).recognize_batch(strips)
    rows_d = SeqRecognizer(params, codec,
                           normalize_on_device=True).recognize_batch(strips)
    for i, (rh, rd) in enumerate(zip(rows_h, rows_d)):
        assert "".join(c for c, _ in rh) == "".join(c for c, _ in rd), i


def test_device_lineest_knife_edge(gpu):
    """Device normalizer vs the scipy CenterNormalizer: identical lengths,
    frames equal outside the +-1 center-truncation boundary set."""
    from text_alignment_tpu.models.lineest import normalize_strip
    from text_alignment_tpu.models.lineest_jax import normalize_batch_device
    from text_alignment_tpu.pipeline.preprocess import (
        identify_text_lines,
        preprocess_images,
    )
    from text_alignment_tpu.synth import make_page

    page = make_page(
        np.random.default_rng(42), n_lines=4, words_per_line=2,
        H=800, W=700, char_h=50, char_w=30, gap=6, space_w=40,
        line_spacing=150, speckles=30, margin_x=30, angle=0.6,
    )
    image, eroded, _ = preprocess_images(page.image, backend="host")
    strips, _, _ = identify_text_lines(image, eroded, backend="host",
                                       verbose=False)
    assert len(strips) >= 3
    B, Hp, Wp = len(strips), 128, 1024
    grey = np.ones((B, Hp, Wp), np.float32)
    hs = np.zeros(B, np.int32)
    ws = np.zeros(B, np.int32)
    for b, s in enumerate(strips):
        h, w = s.img.shape
        grey[b, :h, :w] = 1.0 - s.img.astype(np.float32)
        hs[b], ws[b] = h, w
    frames_d, lengths_d, _ = normalize_batch_device(grey, hs, ws,
                                                    t_max=2048)
    frames_d = np.asarray(frames_d)
    lengths_d = np.asarray(lengths_d)
    for b, s in enumerate(strips):
        ref = normalize_strip(s.img.astype(bool))
        assert ref is not None
        fr, _ = ref
        assert lengths_d[b] == fr.shape[0]
        err = np.abs(frames_d[b, : fr.shape[0]] - fr)
        # f32 summation order can flip the center argmax at
        # int-truncation cliffs, shifting whole dewarp columns by one
        # frame; the bound is the share of such pixels
        assert np.mean(err > 1e-3) < 0.05
        assert np.median(err) < 1e-5


def test_nw_device_matches_host_8191(gpu):
    """Fused device fill+traceback at 8191^2 vs the host fill: the same
    alignment, first-max tie rule included."""
    from text_alignment_tpu.align import perform_alignment

    rng = random.Random(8191)
    t = [rng.choice("abcdefgh ") for _ in range(8191)]
    o = [rng.choice("abcdefgh ") for _ in range(8191)]
    assert (perform_alignment(t, o, backend="jax")
            == perform_alignment(t, o, backend="host"))


def test_nw_device_matches_host_fuzz(gpu):
    """Random pairs across size buckets, square and rectangular."""
    from text_alignment_tpu.align import perform_alignment

    rng = random.Random(1234)
    sizes = [(40, 55), (130, 120), (250, 300), (511, 500),
             (700, 650), (1023, 1100), (1500, 1400), (90, 400)]
    for n, m in sizes:
        t = [rng.choice("abcdefgh ") for _ in range(n)]
        o = [rng.choice("abcdefgh ") for _ in range(m)]
        assert (perform_alignment(t, o, backend="jax")
                == perform_alignment(t, o, backend="host")), (n, m)


def test_align_grid_matches_host_loop(gpu):
    """The 729-combination scoring grid on a chant-page pair: device
    lock-step wavefronts vs one host fill per combination."""
    from text_alignment_tpu.align import perform_alignment
    from text_alignment_tpu.align.api import align_grid
    from text_alignment_tpu.evaluate import scoring_grid
    from text_alignment_tpu.synth import bench_page, corrupt_ocr

    page = bench_page(1236)
    ocr = [c.char for c in corrupt_ocr(np.random.default_rng(5),
                                       page.char_boxes)]
    tra = list(page.transcript)
    params = scoring_grid()
    got = align_grid(tra, ocr, params)
    for p, g in zip(params, got):
        assert g == perform_alignment(tra, ocr, scoring_system=list(p),
                                      backend="host"), p


def test_device_skew_matches_host(gpu):
    """The grouped device skew search is bit-identical to the host search
    (one-hot f32 projections and two-limb int32 criterion are integer
    exact at HIGHEST precision)."""
    from text_alignment_tpu.ops import oracle, skew_device

    rng = np.random.default_rng(99)
    pages = []
    for _ in range(3):
        H, W = int(rng.integers(300, 900)), int(rng.integers(300, 900))
        page = np.zeros((H, W), bool)
        t = np.tan(np.radians(float(rng.uniform(-5, 5))))
        for y0 in range(10, H - 5, max(8, H // 10)):
            xs = rng.integers(0, W, size=W // 2)
            ys = (y0 + t * (xs - W // 2)).astype(int)
            ok = (ys >= 0) & (ys < H)
            page[ys[ok], xs[ok]] = True
        pages.append(page)
    w = skew_device.GroupedSkewWorker(group=2)
    slots = [w.put(p.astype(np.uint8)) for p in pages]
    w.finish()
    for p, s in zip(pages, slots):
        assert w.angle(s) == oracle.rotation_angle_projections(p, -6, 6)


def test_device_raster_matches_host(gpu):
    """The device raster (run-graph CC programs A and B) on bench pages vs
    the host raster: angle, rotated page pixels, line peaks and strip
    boxes identical. Integer scatters (min/add) are order-independent, so
    the device result is exact. Pages whose CC certificate fails take the
    host raster; the count is printed."""
    from text_alignment_tpu.ops.device import unpack_bool
    from text_alignment_tpu.pipeline.device_raster import (
        DevicePage,
        raster_stream_device,
    )
    from text_alignment_tpu.pipeline.preprocess import (
        identify_text_lines,
        preprocess_images,
    )
    from text_alignment_tpu.synth import bench_page

    pages = [bench_page(1240 + i) for i in range(3)]
    out = list(raster_stream_device([p.image for p in pages]))
    fallbacks = sum(not isinstance(o[0], DevicePage) for o in out)
    print(f"device raster: {fallbacks} of {len(pages)} pages took the "
          f"host fallback")
    for page, (image, angle, strips, peaks) in zip(pages, out):
        want_bin, want_er, want_angle = preprocess_images(page.image,
                                                          backend="host")
        want_strips, want_peaks, _ = identify_text_lines(
            want_bin, want_er, backend="host", verbose=False)
        assert angle == want_angle
        assert list(peaks) == list(want_peaks)
        assert len(strips) == len(want_strips)
        if isinstance(image, DevicePage):
            H2, W2 = image.shape
            bits = unpack_bool(np.asarray(image.page_packed), W2)[:H2]
            np.testing.assert_array_equal(bits, want_bin)
        for s, w in zip(strips, want_strips):
            assert (s.offset_x, s.offset_y, s.height, s.width) == \
                (w.offset_x, w.offset_y, w.height, w.width)
