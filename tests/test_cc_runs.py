"""Run-graph device CC (ops.cc_runs) vs the numpy oracle — bit parity on
despeckle / white-despeckle / tall-CC removal / compact stats tables,
including adversarial geometries (spirals, serpentines, diagonal-only
connectivity) chosen to stress the fixed label-propagation budget."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from text_alignment_tpu.ops import cc_runs, oracle


def _spiral(H=120, W=160):
    """Single 1-px spiral component — maximal 'turn count' per area."""
    img = np.zeros((H, W), bool)
    top, bot, lo, hi = 0, H - 1, 0, W - 1
    while top < bot and lo < hi:
        img[top, lo:hi + 1] = True
        img[top:bot + 1, hi] = True
        img[bot, lo:hi + 1] = True
        img[top + 2:bot + 1, lo] = True
        top += 2
        bot -= 2
        lo += 2
        hi -= 2
    return img


def _serpentine(H=100, W=140):
    """One snake component threading every row."""
    img = np.zeros((H, W), bool)
    for y in range(0, H, 2):
        img[y, :] = True
    for i, y in enumerate(range(1, H - 1, 2)):
        img[y, W - 1 if i % 2 == 0 else 0] = True
    return img


def _diagonal_chain(n=64):
    """Pixels touching only diagonally — pure 8-connectivity test."""
    img = np.zeros((n + 1, n + 1), bool)
    for i in range(n):
        img[i, i] = True
    img[n, n] = True
    return img


def _noise(seed, H=96, W=128, p=0.35):
    return np.random.default_rng(seed).random((H, W)) < p


def _checker(H=40, W=48):
    img = np.zeros((H, W), bool)
    img[::2, ::2] = True
    return img


FIXTURES = {
    "empty": np.zeros((32, 48), bool),
    "full": np.ones((32, 48), bool),
    "single_px": np.eye(1, 48, 20, dtype=bool).repeat(16, 0) & False,
    "spiral": _spiral(),
    "serpentine": _serpentine(),
    "diagonal": _diagonal_chain(),
    "checker": _checker(),
    "noise_dense": _noise(1, p=0.45),
    "noise_sparse": _noise(2, p=0.08),
    "noise_mid": _noise(3, p=0.25),
}
FIXTURES["single_px"][8, 20] = True

R_SMALL = 1 << 13


def _ok(flag):
    assert bool(np.asarray(flag)), "kernel did not converge (budget too low)"


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_labels_match_oracle_components(name):
    img = FIXTURES[name]
    rs = cc_runs.extract_runs(jnp.asarray(img), R_SMALL)
    cc = cc_runs.run_cc(rs, img.shape[1])
    _ok(cc.converged)
    assert not bool(np.asarray(cc.overflow))
    # paint each component's runs by oracle label and compare partitions
    labels_o, n_o = oracle.label_ccs(img)
    lbl = np.asarray(cc.lbl)
    n = int(np.asarray(rs.n))
    y, x0 = np.asarray(rs.y)[:n], np.asarray(rs.x0)[:n]
    # two runs share a device root iff they share an oracle label
    dev_root = lbl[:n]
    ora_lab = labels_o[y, x0]
    # bijection check
    assert len(set(zip(dev_root.tolist(), ora_lab.tolist()))) == \
        len(set(dev_root.tolist())) == len(set(ora_lab.tolist())) == n_o


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k", [0, 1, 5, 60])
def test_despeckle_parity(name, k):
    img = FIXTURES[name]
    got, ok = cc_runs.despeckle(jnp.asarray(img), k, R_SMALL)
    _ok(ok)
    np.testing.assert_array_equal(np.asarray(got), oracle.despeckle(img, k))


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k", [1, 25])
def test_despeckle_white_parity(name, k):
    img = FIXTURES[name]
    got, ok = cc_runs.despeckle_white(jnp.asarray(img), k, R_SMALL)
    _ok(ok)
    np.testing.assert_array_equal(
        np.asarray(got), ~oracle.despeckle(~img, k))


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("t", [0, 3, 31])
def test_remove_tall_parity(name, t):
    img = FIXTURES[name]
    got, ok = cc_runs.remove_tall_ccs(jnp.asarray(img), t, R_SMALL)
    _ok(ok)
    np.testing.assert_array_equal(
        np.asarray(got), oracle.remove_tall_ccs(img, t))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_preproc_clean_chain_parity(name):
    img = FIXTURES[name]
    got, ok = cc_runs.preproc_clean(jnp.asarray(img), 10, 20, R_SMALL)
    _ok(ok)
    want = oracle.despeckle(img, 10)
    want = ~oracle.despeckle(~want, 10)
    want = oracle.remove_tall_ccs(want, 20)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("min_area", [None, 4])
def test_cc_table_parity(name, min_area):
    img = FIXTURES[name]
    table, count, ok = cc_runs.cc_table_compact(
        jnp.asarray(img), min_area_keep=min_area, max_ccs=2048,
        max_runs=R_SMALL)
    _ok(ok)
    _, want = oracle.cc_stats(img)
    if min_area is not None:
        want = want[want[:, 4] > min_area]
    count = int(np.asarray(count))
    assert count == len(want)
    np.testing.assert_array_equal(
        np.asarray(table)[:count].astype(np.int64), want)


def test_run_overflow_flag():
    img = np.asarray(_checker(16, 32))
    got, ok = cc_runs.despeckle(jnp.asarray(img), 0, 64)  # 128 runs > 64
    assert not bool(np.asarray(ok))


def test_low_budget_reports_unconverged_never_wrong():
    """With a starved budget the kernel must flag non-convergence rather than
    return plausible-but-wrong labels."""
    img = _spiral(160, 200)
    rs = cc_runs.extract_runs(jnp.asarray(img), R_SMALL)
    edges = cc_runs.run_edges(rs, img.shape[1])
    lbl, conv = cc_runs.label_runs(rs, edges, hooks=1, jumps=0)
    assert not bool(np.asarray(conv))


def test_full_page_size_spiral_converges():
    """A full-page-scale single spiral (the worst realistic turn count)
    still converges inside the default budget."""
    img = _spiral(640, 512)  # ~80k runs, one giant path-graph component
    got, ok = cc_runs.despeckle(jnp.asarray(img), 3, 1 << 17)
    _ok(ok)
    np.testing.assert_array_equal(np.asarray(got), oracle.despeckle(img, 3))


# -- scan-line geometries: word-boundary widths, full rows, rings with
# late merges, corner pixels, bars; each through all filter modes --

def _scanline_cases():
    rng = np.random.default_rng(0)
    cases = {
        "random25": rng.random((100, 90)) < 0.25,
        "random60": rng.random((80, 130)) < 0.6,
        "empty": np.zeros((70, 64), bool),
        "full": np.ones((66, 95), bool),
        "W32": rng.random((40, 32)) < 0.3,
        "W33": rng.random((40, 33)) < 0.3,
        "fullrows": np.ones((40, 100), bool),
    }
    c = np.zeros((50, 50), bool)
    c[0, 0] = c[0, -1] = c[-1, 0] = c[-1, -1] = True
    cases["corners"] = c
    v = np.zeros((90, 70), bool)
    v[:, ::3] = True
    cases["bars"] = v
    s = np.zeros((64, 64), bool)
    for r in range(0, 30, 4):
        s[r, r:64 - r] = True
        s[63 - r, r:64 - r] = True
        s[r:64 - r, r] = True
        s[r:64 - r, 63 - r] = True
    cases["rings"] = s  # rings with full-row runs + late merges
    return cases


SCANLINE = _scanline_cases()


@pytest.mark.parametrize("name", sorted(SCANLINE))
@pytest.mark.parametrize("k", [0, 3, 25, 175])
def test_scanline_filter_modes_match_oracle(name, k):
    img = SCANLINE[name]
    j = jnp.asarray(img)
    got, ok = cc_runs.despeckle(j, k, R_SMALL)
    _ok(ok)
    np.testing.assert_array_equal(np.asarray(got), oracle.despeckle(img, k))
    got, ok = cc_runs.despeckle_white(j, k, R_SMALL)
    _ok(ok)
    np.testing.assert_array_equal(np.asarray(got),
                                  ~oracle.despeckle(~img, k))
    got, ok = cc_runs.remove_tall_ccs(j, max(k, 1), R_SMALL)
    _ok(ok)
    np.testing.assert_array_equal(np.asarray(got),
                                  oracle.remove_tall_ccs(img, max(k, 1)))
    got, ok = cc_runs.remove_tall_ccs(j, max(k, 1), R_SMALL, by_area=True)
    _ok(ok)
    np.testing.assert_array_equal(np.asarray(got),
                                  oracle.remove_big_ccs(img, max(k, 1)))


@pytest.mark.parametrize("name", sorted(SCANLINE))
def test_scanline_preproc_clean_chain(name):
    img = SCANLINE[name]
    got, ok = cc_runs.preproc_clean(jnp.asarray(img), 10, 20, R_SMALL)
    _ok(ok)
    want = oracle.remove_tall_ccs(
        ~oracle.despeckle(~oracle.despeckle(img, 10), 10), 20)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_despeckle_fuzz_parity():
    rng = np.random.default_rng(7)
    for _ in range(40):
        H = int(rng.integers(3, 80))
        W = int(rng.integers(3, 200))
        img = rng.random((H, W)) < float(rng.uniform(0.05, 0.8))
        k = int(rng.integers(0, 30))
        got, ok = cc_runs.despeckle(jnp.asarray(img), k, R_SMALL)
        _ok(ok)
        np.testing.assert_array_equal(np.asarray(got),
                                      oracle.despeckle(img, k))
        got, ok = cc_runs.despeckle_white(jnp.asarray(img), k, R_SMALL)
        _ok(ok)
        np.testing.assert_array_equal(np.asarray(got),
                                      ~oracle.despeckle(~img, k))


def test_strict_false_area_mode_chain():
    """sat_by_area threads through preproc_clean (the strict=False
    corrected filter): a wide short blob goes, a tall thin one stays."""
    ink = np.zeros((240, 260), bool)
    ink[10:13, 20:220] = True    # wide: nrows 3, area 600
    ink[30:230, 240:241] = True  # tall: nrows 200, area 200
    got, ok = cc_runs.preproc_clean(jnp.asarray(ink), 0, 300, R_SMALL,
                                    sat_by_area=True)
    _ok(ok)
    got = np.asarray(got)
    np.testing.assert_array_equal(got, oracle.remove_big_ccs(ink, 300))
    assert not got[11, 100] and got[100, 240]  # area filter, not nrows


def test_cc_table_count_overflow():
    """More components than table rows must report ok=False (host
    fallback), never a truncated table."""
    img = np.zeros((64, 64), bool)
    img[::2, ::2] = True  # 1024 components
    _, _, ok = cc_runs.cc_table_compact(jnp.asarray(img), max_ccs=100,
                                        max_runs=R_SMALL)
    assert not bool(np.asarray(ok))
