"""NW alignment parity tests: fast host fill and JAX wavefront fill must
reproduce the literal reference port exactly (pointers and alignments)."""

import random

import numpy as np
import pytest

from text_alignment_tpu.align import perform_alignment, resolve_scoring
from text_alignment_tpu.align.nw_host import (
    fill_reference_slow,
    fill_host_fast,
)
from text_alignment_tpu.align.nw_jax import fill_jax_packed
from text_alignment_tpu.align.traceback import (
    DensePtrView,
    DiagPtrView,
    traceback,
)


def _random_pair(rng, n, m, alphabet="abcdefg "):
    t = [rng.choice(alphabet) for _ in range(n)]
    o = [rng.choice(alphabet) for _ in range(m)]
    return t, o


def _corrupted_pair(rng, n):
    t = [rng.choice("abcdefghij ") for _ in range(n)]
    o = list(t)
    for _ in range(max(1, n // 8)):
        k = rng.randrange(len(o))
        op = rng.random()
        if op < 0.4:
            o[k] = rng.choice("abcdefghij ")
        elif op < 0.7 and len(o) > 2:
            del o[k]
        else:
            o.insert(k, rng.choice("abcdefghij "))
    return t, o


SYSTEMS = [
    None,                      # default [8, -4, -7, -7, -3, 0]
    [10, -5, -7, -7],          # 4-form
    [5, -4, -2, -7, 0, -3],    # 6-form, asymmetric
]


@pytest.mark.parametrize("scoring", SYSTEMS)
def test_fast_host_fill_matches_reference(scoring):
    rng = random.Random(0)
    sc = resolve_scoring(scoring)
    for n, m in [(3, 5), (10, 12), (30, 25), (60, 70)]:
        t, o = _corrupted_pair(rng, n)
        t, o = t + [" "], o + [" "]
        ref = fill_reference_slow(t, o, sc)
        fast = fill_host_fast(t, o, sc)
        for a, b, name in zip(ref, fast, ("mat", "x", "y")):
            np.testing.assert_array_equal(
                a[1:, 1:], b[1:, 1:], err_msg=f"{name} ptr mismatch n={n} m={m}"
            )


@pytest.mark.parametrize("scoring", SYSTEMS)
def test_jax_fill_matches_reference(scoring):
    rng = random.Random(1)
    sc = resolve_scoring(scoring)
    for n, m in [(5, 9), (33, 41), (100, 90)]:
        t, o = _random_pair(rng, n, m)
        t, o = t + [" "], o + [" "]
        ref_ptrs = DensePtrView(*fill_reference_slow(t, o, sc))
        jax_ptrs = DiagPtrView(fill_jax_packed(t, o, sc))
        for i in range(1, len(t)):
            for j in range(1, len(o)):
                assert ref_ptrs.mat(i, j) == jax_ptrs.mat(i, j), (i, j)
                assert ref_ptrs.x(i, j) == jax_ptrs.x(i, j), (i, j)
                assert ref_ptrs.y(i, j) == jax_ptrs.y(i, j), (i, j)


def test_alignment_equal_length_and_gaps():
    t = list("dominus vobiscum")
    o = list("dominvs vob1scum et")
    a, b = perform_alignment(t, o, backend="host")
    assert len(a) == len(b)
    assert [c for c in a if c != "_"] == t
    assert [c for c in b if c != "_"] == o


def test_backends_agree_end_to_end():
    rng = random.Random(2)
    for n in (20, 64, 150):
        t, o = _corrupted_pair(rng, n)
        res_ref = perform_alignment(t, o, backend="reference")
        res_host = perform_alignment(t, o, backend="host")
        res_jax = perform_alignment(t, o, backend="jax")
        assert res_ref == res_host == res_jax


def test_reference_main_fixture():
    """The reference's only self-contained demo (textSeqCompare.py:180-189):
    bigram-chunked lorem ipsum with deliberate corruptions."""
    seq1 = "Lorem ipsum dolor sit amet, consectetur adipiscing elit "
    seq2 = "LoLorem fipsudolor ..... sit eamet, c.nnr adizisdcing eelitellit"
    seq1 = [seq1[2 * x] + seq1[2 * x + 1] for x in range(len(seq1) // 2)]
    seq2 = [seq2[2 * x] + seq2[2 * x + 1] for x in range(len(seq2) // 2)]

    a, b = perform_alignment(seq1, seq2, scoring_system=[10, -5, -7, -7],
                             backend="host")
    a2, b2 = perform_alignment(seq1, seq2, scoring_system=[10, -5, -7, -7],
                               backend="reference")
    assert (a, b) == (a2, b2)
    # multi-element tokens survive alignment; gaps are single '_' symbols
    assert len(a) == len(b)
    assert [x for x in a if x != "_"] == seq1
    assert [x for x in b if x != "_"] == seq2

    a3, b3 = perform_alignment(seq1, seq2, scoring_system=[10, -5, -7, -7],
                               backend="jax")
    assert (a3, b3) == (a, b)


def test_callable_scoring_system():
    def score(x, y):
        return 12 if x == y else -6

    t, o = list("abcabc"), list("abxabc")
    r1 = perform_alignment(t, o, scoring_system=[score, -7, -7, -3, 0],
                           backend="reference")
    r2 = perform_alignment(t, o, scoring_system=[score, -7, -7, -3, 0],
                           backend="host")
    r3 = perform_alignment(t, o, scoring_system=[score, -7, -7, -3, 0],
                           backend="jax")
    assert r1 == r2 == r3


def test_invalid_scoring_system():
    with pytest.raises(ValueError):
        perform_alignment(list("ab"), list("ab"), scoring_system=[1, 2, 3])


def test_align_grid_jax_matches_host():
    from text_alignment_tpu.align.nw_jax import align_grid_jax

    rng = random.Random(7)
    t, o = _corrupted_pair(rng, 60)
    params = [
        [8, -4, -7, -7, -3, 0],
        [5, -4, -2, -2, 0, 0],
        [11, -10, -7, -7, -5, -5],
        [10, -5, -7, -7, -7, -7],
    ]
    grid_results = align_grid_jax(t, o, params)
    for p, got in zip(params, grid_results):
        want = perform_alignment(t, o, scoring_system=p, backend="host")
        assert tuple(got) == tuple(want), p


@pytest.mark.parametrize("scoring", SYSTEMS)
def test_native_fill_matches_reference(scoring):
    from text_alignment_tpu.ops import host_native
    from text_alignment_tpu.align.nw_host import fill_native

    if not host_native.available():
        pytest.skip("native toolchain unavailable")
    rng = random.Random(3)
    sc = resolve_scoring(scoring)
    for n, m in [(3, 5), (10, 12), (30, 25), (60, 70), (150, 140)]:
        t, o = _corrupted_pair(rng, n)
        t, o = t + [" "], o + [" "]
        ref = fill_reference_slow(t, o, sc)
        nat = fill_native(t, o, sc)
        for a, b, name in zip(ref, nat, ("mat", "x", "y")):
            np.testing.assert_array_equal(
                a[1:, 1:], b[1:, 1:], err_msg=f"{name} ptr mismatch n={n} m={m}"
            )


def test_align_pairs_small_pair_host_routing():
    """align_pairs_jax's host shortcut for small pairs must equal the
    forced-device bucket path alignment for alignment."""
    from text_alignment_tpu.align.nw_jax import align_pairs_jax

    rng = random.Random(11)
    sc = resolve_scoring(None)
    pairs = []
    for n in (8, 40, 90):
        t, o = _corrupted_pair(rng, n)
        pairs.append((t, o))
    via_host = align_pairs_jax(pairs, sc)               # default: all host
    via_dev = align_pairs_jax(pairs, sc, min_device_cells=0)  # all device
    assert via_host == via_dev
    for (ta, oa), (t, o) in zip(via_host, pairs):
        ref = perform_alignment(t, o, backend="reference")
        assert (ta, oa) == ref


def test_fuzz_random_scorings_all_fills_agree():
    """Randomized integer scoring systems x random pairs: the literal
    reference fill, the fast host fill, the native C++ fill (when built),
    and the XLA wavefront must produce identical ALIGNMENTS (pointers feed
    tie-breaking, so this catches candidate-order drift under scorings the
    fixed SYSTEMS list never exercises)."""
    from text_alignment_tpu.align.nw_host import _native_nw_available

    rng = random.Random(7)
    for trial in range(10):
        match = rng.randrange(1, 13)
        mismatch = -rng.randrange(0, 11)
        gox, goy = -rng.randrange(0, 9), -rng.randrange(0, 9)
        gex, gey = -rng.randrange(0, 6), -rng.randrange(0, 6)
        sc_list = [match, mismatch, gox, goy, gex, gey]
        n, m = rng.randrange(2, 60), rng.randrange(2, 60)
        t, o = _random_pair(rng, n, m)
        t, o = t + [" "], o + [" "]
        sc = resolve_scoring(sc_list)

        ref = traceback(t, o, DensePtrView(*fill_reference_slow(t, o, sc)))
        fast = traceback(t, o, DensePtrView(*fill_host_fast(t, o, sc)))
        assert fast == ref, (trial, sc_list)
        jaxp = traceback(
            t, o, DiagPtrView(fill_jax_packed(t, o, sc))
        )
        assert jaxp == ref, (trial, sc_list)
        if _native_nw_available():
            from text_alignment_tpu.align.nw_host import fill_native

            nat = traceback(
                t, o, DensePtrView(*fill_native(t, o, sc))
            )
            assert nat == ref, (trial, sc_list)


def test_device_pairs_sharing_a_bucket_match_host():
    """Mixed-length pairs that share one (L, NoP) bucket ride a single
    vmapped device dispatch; each alignment equals its host fill."""
    from text_alignment_tpu.align.nw_jax import _bucket, align_pairs_jax

    rng = random.Random(7)
    sc = resolve_scoring(None)
    pairs = [_random_pair(rng, n, m, "abcde ")
             for n, m in ((40, 55), (100, 90), (7, 120))]
    assert len({(_bucket(len(t) + 1), _bucket(len(o) + 1))
                for t, o in pairs}) == 1
    got = align_pairs_jax(pairs, sc, min_device_cells=0)
    for (t, o), g in zip(pairs, got):
        assert g == perform_alignment(t, o, backend="host")


def test_device_grid_per_row_scoring_across_chunks():
    """The scoring grid reads each row's own parameters: rows split over
    several chunks (the last one partial) each equal the host fill under
    that scoring."""
    from text_alignment_tpu.align.nw_jax import align_grid_jax

    rng = random.Random(3)
    t, o = _random_pair(rng, 60, 85, "abcde ")
    params = [
        [5, -4, -2, -2, 0, 0],
        [8, -4, -7, -7, -3, 0],
        [11, -10, -7, -2, -5, 0],
        [5, -7, -2, -7, 0, -5],
        [8, -10, -5, -5, 0, -3],
    ]
    got = align_grid_jax(t, o, params, chunk=2)
    assert len(got) == len(params)
    for p, g in zip(params, got):
        assert tuple(g) == tuple(perform_alignment(
            t, o, scoring_system=list(p), backend="host")), p


@pytest.mark.parametrize("n,m", [(90, 300), (300, 90)])
def test_device_pointers_rectangular_match_host(n, m):
    """Rectangular problems (different transcript and OCR buckets): the
    device's diagonal-layout pointers trace back to the host alignment."""
    rng = random.Random(n * 1000 + m)
    t, o = _random_pair(rng, n, m, "abcde ")
    t, o = t + [" "], o + [" "]
    sc = resolve_scoring(None)
    want = traceback(t, o, DensePtrView(*fill_host_fast(t, o, sc)))
    assert traceback(t, o, DiagPtrView(fill_jax_packed(t, o, sc))) == want


def test_device_traceback_ops_replay_match_host():
    """The on-device traceback's op stream, replayed on the host, equals
    the host traceback — windows ending mid-unroll and rectangular shapes
    included."""
    from text_alignment_tpu.align.nw_jax import align_jax_ops, replay_ops

    sc = resolve_scoring(None)
    rng = random.Random(5)
    for n, m in ((40, 55), (100, 230), (230, 100), (7, 120)):
        t, o = _random_pair(rng, n, m, "abcde ")
        t, o = t + [" "], o + [" "]
        want = traceback(t, o, DensePtrView(*fill_host_fast(t, o, sc)))
        assert replay_ops(t, o, *align_jax_ops(t, o, sc)) == want, (n, m)
