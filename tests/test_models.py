"""OCR model layer tests: JAX BiLSTM vs numpy oracle, CTC decode parity,
pyrnn round-trip, normalization, and a training smoke test."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from text_alignment_tpu.models.lstm_np import (
    lstm_forward_np,
    bilstm_forward_np,
)
from text_alignment_tpu.models.lstm_jax import (
    init_bilstm,
    bilstm_forward_batched,
    params_from_np,
    params_to_np,
)
from text_alignment_tpu.models.ctc import (
    translate_back_np,
    translate_back_batched,
    llocs_positions,
)
from text_alignment_tpu.models.codec import Codec
from text_alignment_tpu.models.pyrnn import load_pyrnn, save_pyrnn
from text_alignment_tpu.models.lineest import (
    CenterNormalizer,
    prepare_line,
    normalize_strip,
)
from text_alignment_tpu.models.recognizer import SeqRecognizer
from text_alignment_tpu.models.train import Trainer, batch_lines


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def _np_params(rng, ni=8, ns=12, nout=6):
    def w():
        na = 1 + ni + ns
        return {
            "WGI": rng.normal(0, 0.3, (ns, na)).astype(np.float32),
            "WGF": rng.normal(0, 0.3, (ns, na)).astype(np.float32),
            "WGO": rng.normal(0, 0.3, (ns, na)).astype(np.float32),
            "WCI": rng.normal(0, 0.3, (ns, na)).astype(np.float32),
            "WIP": rng.normal(0, 0.3, ns).astype(np.float32),
            "WFP": rng.normal(0, 0.3, ns).astype(np.float32),
            "WOP": rng.normal(0, 0.3, ns).astype(np.float32),
        }

    return {"fwd": w(), "bwd": w(), "W2": rng.normal(0, 0.3, (nout, 2 * ns + 1)).astype(np.float32)}


def test_bilstm_jax_matches_numpy_oracle(rng):
    d = _np_params(rng)
    params = params_from_np(d)
    lengths = [5, 9, 13]
    T = 16
    xs = np.zeros((3, T, 8), np.float32)
    refs = []
    for b, L in enumerate(lengths):
        x = rng.normal(0, 1, (L, 8)).astype(np.float32)
        xs[b, :L] = x
        refs.append(bilstm_forward_np(d, x))
    out = np.asarray(
        bilstm_forward_batched(params, jnp.asarray(xs), jnp.asarray(lengths, jnp.int32))
    )
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(out[b, :L], refs[b], rtol=2e-5, atol=2e-6)


def test_lstm_t0_peephole_quirk(rng):
    """WOP must not contribute at t=0 (ocropy quirk)."""
    d = _np_params(rng)["fwd"]
    x = rng.normal(0, 1, (1, 8)).astype(np.float32)
    base = lstm_forward_np(d, x)
    d2 = dict(d)
    d2["WOP"] = d["WOP"] + 100.0
    mod = lstm_forward_np(d2, x)
    np.testing.assert_array_equal(base, mod)


def test_translate_back_oracle():
    # two regions: frames 1-3 and 6-7, blank elsewhere
    T, C = 10, 4
    out = np.zeros((T, C), np.float32)
    out[:, 0] = 0.9
    out[1:4, 0] = 0.1
    out[1:4, 2] = [0.5, 0.8, 0.6]
    out[6:8, 0] = 0.2
    out[6:8, 3] = [0.7, 0.71]
    res = translate_back_np(out)
    assert res == [(2, 2), (7, 3)]


def test_translate_back_batched_matches_oracle(rng):
    B, T, C = 4, 40, 8
    logits = rng.normal(0, 2, (B, T, C)).astype(np.float32)
    outs = np.exp(logits)
    outs /= outs.sum(axis=2, keepdims=True)
    lengths = np.array([40, 31, 17, 5], np.int32)
    fr, cl, cnt = translate_back_batched(
        jnp.asarray(outs), jnp.asarray(lengths), max_regions=64
    )
    fr, cl, cnt = np.asarray(fr), np.asarray(cl), np.asarray(cnt)
    for b in range(B):
        ref = translate_back_np(outs[b, : lengths[b]])
        n = int(cnt[b])
        assert n == len(ref)
        assert [(int(f), int(c)) for f, c in zip(fr[b, :n], cl[b, :n])] == ref


def test_llocs_positions_one_decimal():
    xs = llocs_positions([16, 20, 100], raw_width=300, T_total=332, pad=16)
    scale = 300.0 / 300.0
    assert xs[0] == 0.0
    assert xs[1] == round((20 - 16) * scale, 1)
    assert all(x == round(x, 1) for x in xs)


def test_pyrnn_roundtrip(tmp_path, rng):
    d = _np_params(rng, ni=48, ns=10, nout=5)
    codec = Codec(["", "~", " ", "a", "b"])
    path = str(tmp_path / "model-00001234.pyrnn.gz")
    save_pyrnn(path, d, codec, 48)
    params2, codec2, th = load_pyrnn(path)
    assert th == 48
    assert codec2 == codec
    for part in ("fwd", "bwd"):
        for k in d[part]:
            np.testing.assert_array_equal(d[part][k], params2[part][k])
    np.testing.assert_array_equal(d["W2"], params2["W2"])


def test_center_normalizer_shapes(rng):
    strip = np.zeros((30, 200), dtype=bool)
    strip[12:20, 10:190] = rng.random((8, 180)) < 0.6
    res = normalize_strip(strip)
    assert res is not None
    frames, raw_w = res
    assert raw_w == 200
    assert frames.shape[1] == 48
    assert frames.shape[0] > 2 * 16  # content + padding
    assert frames.dtype == np.float32
    assert 0.0 <= frames.min() and frames.max() <= 1.0
    # padding frames are zero
    assert np.all(frames[:16] == 0) and np.all(frames[-16:] == 0)


def test_normalize_blank_strip():
    assert normalize_strip(np.zeros((20, 50), dtype=bool)) is None


def test_prepare_line_polarity():
    line = np.ones((10, 20), np.float32)  # all white
    line[4:6, 5:15] = 0.0  # ink
    out = prepare_line(line, pad=2)
    assert out.shape == (24, 10)
    assert out.max() == 1.0  # ink became 1
    assert np.all(out[:2] == 0)


def test_recognizer_end_to_end_shapes(rng):
    codec = Codec()
    rec = SeqRecognizer(
        init_bilstm(jax.random.PRNGKey(0), 48, 20, len(codec)), codec
    )
    strips = []
    for w in (150, 200, 620):
        s = np.zeros((26, w), dtype=bool)
        s[8:18, 5 : w - 5] = rng.random((10, w - 10)) < 0.5
        strips.append(s)
    strips.append(np.zeros((26, 100), dtype=bool))  # blank
    res = rec.recognize_batch(strips)
    assert len(res) == 4
    assert res[3] == []
    for rows, s in zip(res[:3], strips[:3]):
        for ch, x in rows:
            assert ch in codec.charset
            assert -20 <= x <= s.shape[1] + 20
        # x positions are nondecreasing along the line
        xs = [x for _, x in rows]
        assert xs == sorted(xs)


def test_training_loss_decreases(rng):
    codec = Codec(["", "~", " ", "a", "b", "c"])
    tr = Trainer(codec, ni=16, ns=16, lr=5e-3, seed=1)
    # synthetic task: three distinct frame patterns -> 'abc'
    frames = []
    texts = []
    for _ in range(8):
        f = np.zeros((30, 16), np.float32)
        f[2:8, 2:6] = 1.0
        f[12:18, 6:10] = 1.0
        f[22:28, 10:14] = 1.0
        f += rng.normal(0, 0.05, f.shape).astype(np.float32)
        frames.append(f)
        texts.append("abc")
    xs, xl, lb, ll = batch_lines(frames, texts, codec, T=32, S=8)
    losses = [tr.step(xs, xl, lb, ll) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5
    assert np.isfinite(losses).all()


def test_trainer_checkpoint_roundtrip(tmp_path, rng):
    codec = Codec(["", "~", " ", "a"])
    tr = Trainer(codec, ni=8, ns=6, seed=3)
    tr.iteration = 777
    path = tr.save(str(tmp_path / "synth"))
    assert path.endswith("-00000777.pyrnn.gz")
    rec = SeqRecognizer.from_pyrnn(path)
    assert rec.codec == codec
    got = params_to_np(rec.params)
    want = params_to_np(tr.params)
    for part in ("fwd", "bwd"):
        for k in want[part]:
            np.testing.assert_array_equal(want[part][k], got[part][k])


def test_load_genuine_py2_pyrnn(tmp_path, rng):
    """The loader must read the REAL container format: a Python-2
    protocol-2 pickle (old-style OBJ opcodes, py2-str payloads,
    numpy-1.15 _reconstruct reduce forms), not just our own py3 writer
    (reference contract: alignToOCR.py:27-31)."""
    import gzip
    import pickletools
    from py2pickle import build_py2_pyrnn

    d = _np_params(rng, ni=48, ns=7, nout=6)
    charset = ["", "~", " ", "a", "ā", "b"]  # incl. a-macron abbrev char
    blob = build_py2_pyrnn(d, charset, target_height=48)
    # sanity: the stream really is protocol 2 and uses the py2-only opcodes
    ops = [op.name for op, _, _ in pickletools.genops(blob)]
    assert "OBJ" in ops and ("SHORT_BINSTRING" in ops or "BINSTRING" in ops)
    assert "NEWOBJ" not in ops  # old-style classes never emit NEWOBJ

    path = str(tmp_path / "salzinnes_model-00054500.pyrnn.gz")
    with gzip.open(path, "wb") as f:
        f.write(blob)

    params2, codec2, th = load_pyrnn(path)
    assert th == 48
    assert codec2.charset == charset
    for part in ("fwd", "bwd"):
        for k in d[part]:
            np.testing.assert_array_equal(d[part][k], params2[part][k])
    np.testing.assert_array_equal(
        np.asarray(d["W2"], np.float32), params2["W2"]
    )


def test_load_genuine_py2_pyrnn_swapped_parallel_order(tmp_path, rng):
    """Direction detection must come from the Reversed wrapper, not list
    order: build the same graph with Parallel.nets = [Reversed[bwd], fwd]."""
    import gzip
    from py2pickle import (build_py2_pyrnn, _obj, _py2_str, _list, _ndarray,
                           _int, PROTO, STOP)

    d = _np_params(rng, ni=48, ns=5, nout=4)
    blob = build_py2_pyrnn(d, ["", "~", "x", "y"], target_height=48)

    # rebuild with swapped order by constructing the graph manually
    keys = ("WGI", "WGF", "WGO", "WCI", "WIP", "WFP", "WOP")

    def lstm(w):
        return _obj("ocrolib.lstm", "LSTM", [
            (_py2_str(k.encode()), _ndarray(np.asarray(w[k], np.float32)))
            for k in keys
        ])

    rev = _obj("ocrolib.lstm", "Reversed",
               [(_py2_str(b"net"), lstm(d["bwd"]))])
    par = _obj("ocrolib.lstm", "Parallel",
               [(_py2_str(b"nets"), _list([rev, lstm(d["fwd"])]))])
    soft = _obj("ocrolib.lstm", "Softmax",
                [(_py2_str(b"W2"),
                  _ndarray(np.asarray(d["W2"], np.float32)))])
    stack = _obj("ocrolib.lstm", "Stacked",
                 [(_py2_str(b"nets"), _list([par, soft]))])
    rec = _obj("ocrolib.lstm", "SeqRecognizer",
               [(_py2_str(b"lstm"), stack)])
    blob = PROTO + rec + STOP

    path = str(tmp_path / "m-00017000.pyrnn.gz")
    with gzip.open(path, "wb") as f:
        f.write(blob)
    params2, _, _ = load_pyrnn(path)
    for part in ("fwd", "bwd"):
        for k in d[part]:
            np.testing.assert_array_equal(d[part][k], params2[part][k])


def test_bestpath_batched_matches_oracle(rng):
    """mode="bestpath" of translate_back_batched == bestpath_np, and
    mode="region" == translate_back_np, over random posteriors incl. the
    run-seam and first-max-peak cases; counts cap at max_regions."""
    import jax.numpy as jnp
    from text_alignment_tpu.models.ctc import (
        translate_back_np, bestpath_np, translate_back_batched,
    )

    B, T, C = 6, 90, 7
    outputs = rng.random((B, T, C)).astype(np.float32)
    outputs /= outputs.sum(axis=2, keepdims=True)
    # some peaky frames and some repeated argmax runs
    outputs[:, ::7, 0] = 2.0
    outputs[:, 20:26, 3] = 3.0
    lengths = np.array([90, 80, 73, 90, 1, 45], np.int32)
    from text_alignment_tpu.models.ctc import region_end_np

    for mode, oracle_fn in (("bestpath", bestpath_np),
                            ("region", translate_back_np),
                            ("region_end", region_end_np)):
        fr, cl, cnt = translate_back_batched(
            jnp.asarray(outputs), jnp.asarray(lengths), max_regions=16,
            mode=mode)
        fr, cl, cnt = np.asarray(fr), np.asarray(cl), np.asarray(cnt)
        for b in range(B):
            ref = oracle_fn(outputs[b, : lengths[b]])
            n = min(len(ref), 16)
            assert cnt[b] == n, (mode, b, cnt[b], len(ref))
            assert [(int(f), int(c)) for f, c in
                    zip(fr[b, :n], cl[b, :n])] == ref[:n], (mode, b)


def test_trainer_full_state_resume_exact(tmp_path, rng):
    """save_state/load_state resume the training trajectory bit-exactly
    (params AND Adam moments survive, unlike the weights-only .pyrnn)."""
    from text_alignment_tpu.models.train import Trainer, batch_lines

    codec = Codec()
    xs = rng.random((4, 128, 48)).astype(np.float32)
    xlens = np.full(4, 100, np.int32)
    labels = rng.integers(1, 30, (4, 10)).astype(np.int32)
    llens = np.full(4, 8, np.int32)

    tr = Trainer(codec=codec, ns=20, lr=3e-3, seed=5)
    for _ in range(3):
        tr.step(xs, xlens, labels, llens)
    path = tr.save_state(str(tmp_path / "t.state"),
                         extra={"batch_size": 16})
    # the .state format is a pickle-free npz (zip magic), so loading an
    # untrusted checkpoint cannot execute code
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"

    # the CLI stores the batch-sampling RNG's bit-generator state in extra
    # (exact continuation across CHAINED resumes at different batch
    # sizes); it must survive the JSON-in-npz round trip bit-exactly
    gen = np.random.default_rng(9)
    gen.integers(0, 10, 5)
    path_rng = tr.save_state(str(tmp_path / "r.state"),
                             extra={"rng_state": gen.bit_generator.state})
    tr_rng = type(tr).load_state(path_rng)
    gen2 = np.random.default_rng(0)
    gen2.bit_generator.state = tr_rng.loaded_extra["rng_state"]
    assert np.array_equal(gen.integers(0, 99, 8), gen2.integers(0, 99, 8))

    loss_direct = [tr.step(xs, xlens, labels, llens) for _ in range(2)]

    tr2 = Trainer.load_state(path)
    assert tr2.iteration == 3
    assert tr2.codec.charset == codec.charset
    # caller-side settings round-trip (the CLI replays the original run's
    # RNG draw stream at the SAVED batch size on resume)
    assert tr2.loaded_extra == {"batch_size": 16}
    loss_resumed = [tr2.step(xs, xlens, labels, llens) for _ in range(2)]
    assert loss_direct == loss_resumed


@pytest.mark.parametrize("T", [3, 15, 16, 17])
def test_bilstm_scan_matches_numpy_oracle_at_padded_length(rng, T):
    """The unrolled scan computes the recurrence whatever the padded
    length: below one unroll, not a multiple of it, and a multiple of it,
    with lines shorter than the padding."""
    d = _np_params(rng)
    params = params_from_np(d)
    lengths = [T, max(1, T // 4), max(1, T - 4)]
    xs = np.zeros((3, T, 8), np.float32)
    refs = []
    for b, L in enumerate(lengths):
        x = rng.normal(0, 1, (L, 8)).astype(np.float32)
        xs[b, :L] = x
        refs.append(bilstm_forward_np(d, x))
    out = np.asarray(bilstm_forward_batched(
        params, jnp.asarray(xs), jnp.asarray(lengths, jnp.int32)))
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(out[b, :L], refs[b], rtol=2e-5, atol=2e-6)
