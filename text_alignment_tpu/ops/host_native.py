"""ctypes bindings for the native C++ host raster engine (native/raster.cpp).

Compiled on first use with g++ into ``<checkout>/.cache/native`` (listed
in ``.gitignore``); every function is a semantics-exact accelerated
version of the numpy oracle (tested in tests/test_native.py).
``available()`` gates use — import never fails when a toolchain is
missing: callers fall back to the oracle, and the build error is reported
once on stderr (``load_error()`` returns it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

from ..utils.compile_cache import LOCAL_CACHE

def _find_src() -> str:
    """Locate native/raster.cpp: the repo layout (native/ beside the
    package), or TEXT_ALIGNMENT_TPU_NATIVE_SRC for relocated installs.
    A missing source is not an error here — _build_and_load degrades to
    the numpy oracle via available()."""
    env = os.environ.get("TEXT_ALIGNMENT_TPU_NATIVE_SRC")
    if env:
        return env
    return os.path.join(
        os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "raster.cpp",
    )


_SRC = _find_src()
_lib = None
_load_error: str | None = None


def _build_and_load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(src).hexdigest()[:16]
        build_dir = os.path.join(LOCAL_CACHE, "native")
        os.makedirs(build_dir, exist_ok=True)
        so_path = os.path.join(build_dir, f"raster_{tag}.so")
        if not os.path.exists(so_path):
            # per-process temp name: concurrent first users (test workers,
            # server processes) each build and atomically publish
            tmp = f"{so_path}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", tmp, _SRC],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32

        lib.ta_cc_label.restype = i32
        lib.ta_cc_label.argtypes = [u8p, i64, i64, i32p]
        lib.ta_cc_stats.restype = i32
        lib.ta_cc_stats.argtypes = [u8p, i64, i64, i64p, i32]
        lib.ta_despeckle.argtypes = [u8p, i64, i64, i64]
        lib.ta_remove_small.argtypes = [u8p, i64, i64, i64]
        lib.ta_remove_tall.argtypes = [u8p, i64, i64, i64]
        lib.ta_filter_runs.argtypes = [u8p, i64, i64, i64, i32, i32]
        lib.ta_projection_rows.argtypes = [u8p, i64, i64, i64p]
        lib.ta_black_area.restype = i64
        lib.ta_black_area.argtypes = [u8p, i64]
        lib.ta_shear_projections.argtypes = [u8p, i64, i64, i32p, i64, i64p]
        lib.ta_greyscale.argtypes = [u8p, i64, i32, u8p]
        lib.ta_grey_histogram.argtypes = [u8p, i64, i64p]
        lib.ta_rotate_onebit.argtypes = [u8p, i64, i64, i64, i64, i32, i32,
                                         i32, u8p]
        lib.ta_black_runs.restype = i64
        lib.ta_black_runs.argtypes = [u8p, i64, i64, i32p, i64]
        lib.ta_erode2.argtypes = [u8p, i64, i64, u8p]
        lib.ta_binarize.argtypes = [u8p, i64, i32, u8p]
        lib.ta_preproc_stage1.argtypes = [u8p, i64, i64, i64, i64, i64]
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.ta_greyscale_hist.argtypes = [u8p, i64, i32, u8p, i64p]
        lib.ta_preproc_stage1_runs.restype = i64
        lib.ta_preproc_stage1_runs.argtypes = [u8p, i64, i64, i64, i64,
                                               i32p, i64, i64]
        lib.ta_cc_stats_masked.restype = i32
        lib.ta_cc_stats_masked.argtypes = [u8p, i64, i64, u8p, i64p, i32]
        lib.ta_rotate_runs.argtypes = [i32p, i64, i64, i64, i64, i64, i32,
                                       i32, i32, u8p]
        lib.ta_shear_projections_runs32.argtypes = [i32p, i64, i32p, i64,
                                                    i64, i64, i32p]
        lib.ta_preproc_grey_stage1_runs.restype = i64
        lib.ta_preproc_grey_stage1_runs.argtypes = [u8p, i64, i64, i32,
                                                    i64, i64, u8p, i32p,
                                                    i64, i64]
        lib.ta_nw_fill.argtypes = [i32p, i64, i32p, i64, i64, i64, i64,
                                   i64, i64, i64, i64, i8p, i8p, i8p]
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.ta_nearest_higher.argtypes = [f64p, i64, i32p, i32p]
        lib.ta_rotate_runs2.restype = i64
        lib.ta_rotate_runs2.argtypes = [i32p, i64, i64, i64, i64, i64, i32,
                                        i32, i32, u8p, i32p, i64]
        lib.ta_pack_runs_into.argtypes = [i32p, i64, u8p, i64]
        lib.ta_erode_runs.restype = i64
        lib.ta_erode_runs.argtypes = [i32p, i64, i64, i32p, i64, i64p]
        lib.ta_cc_stats_from_runs.restype = i32
        lib.ta_cc_stats_from_runs.argtypes = [i32p, i64, i64, u8p, i64p,
                                              i32]
        assert lib.ta_abi_version() == 14
        _lib = lib
    except Exception as e:  # no toolchain / build failure -> oracle fallback
        detail = getattr(e, "stderr", None) or ""
        _load_error = f"{e!r} {detail}".strip()
        print(f"native raster engine unavailable, using the numpy oracle: "
              f"{_load_error}", file=sys.stderr)


def available() -> bool:
    _build_and_load()
    return _lib is not None


def load_error() -> str | None:
    """Why the native engine did not load (None when it loaded or has
    not been tried)."""
    _build_and_load()
    return _load_error


def _as_u8(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img, dtype=np.uint8)


def _as_u8_ro(img: np.ndarray) -> np.ndarray:
    """uint8 view for READ-ONLY native calls: a contiguous bool array is
    reinterpreted in place (numpy bools are one 0/1 byte) instead of copied.
    Never pass the result to an in-place native op."""
    if img.dtype == np.bool_ and img.flags.c_contiguous:
        return img.view(np.uint8)
    return np.ascontiguousarray(img, dtype=np.uint8)


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def cc_label(img: np.ndarray):
    _build_and_load()
    a = _as_u8_ro(img)
    H, W = a.shape
    labels = np.zeros((H, W), np.int32)
    n = _lib.ta_cc_label(_u8p(a), H, W,
                         labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, int(n)


def cc_stats(img: np.ndarray, max_ccs: int = 1 << 20):
    _build_and_load()
    a = _as_u8_ro(img)
    H, W = a.shape
    table = np.zeros((max_ccs, 5), np.int64)
    n = _lib.ta_cc_stats(_u8p(a), H, W,
                         table.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         max_ccs)
    if n > max_ccs:
        # fail loudly like the device path (_cc_table) rather than silently
        # dropping components on pathologically dense pages
        raise RuntimeError(f"page has {n} CCs > max_ccs={max_ccs}")
    return table[:n].copy()


def despeckle(img: np.ndarray, k: int) -> np.ndarray:
    _build_and_load()
    a = _as_u8(img)
    _lib.ta_despeckle(_u8p(a), a.shape[0], a.shape[1], k)
    return a.astype(bool)


def remove_small_ccs(img: np.ndarray, min_area: int) -> np.ndarray:
    _build_and_load()
    a = _as_u8(img)
    _lib.ta_remove_small(_u8p(a), a.shape[0], a.shape[1], min_area)
    return a.astype(bool)


def remove_tall_ccs(img: np.ndarray, max_nrows: int) -> np.ndarray:
    _build_and_load()
    a = _as_u8(img)
    _lib.ta_remove_tall(_u8p(a), a.shape[0], a.shape[1], max_nrows)
    return a.astype(bool)


def filter_short_runs(img: np.ndarray, k: int, color: str = "black") -> np.ndarray:
    _build_and_load()
    a = _as_u8(img)
    _lib.ta_filter_runs(_u8p(a), a.shape[0], a.shape[1], k,
                        1 if color == "black" else 0, 0)
    return a.astype(bool)


def filter_narrow_runs(img: np.ndarray, k: int, color: str = "black") -> np.ndarray:
    _build_and_load()
    a = _as_u8(img)
    _lib.ta_filter_runs(_u8p(a), a.shape[0], a.shape[1], k,
                        1 if color == "black" else 0, 1)
    return a.astype(bool)


def projection_rows(img: np.ndarray) -> np.ndarray:
    _build_and_load()
    a = _as_u8_ro(img)
    proj = np.zeros(a.shape[0], np.int64)
    _lib.ta_projection_rows(_u8p(a), a.shape[0], a.shape[1],
                            proj.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return proj


def black_area(img: np.ndarray) -> int:
    _build_and_load()
    a = _as_u8_ro(img)
    return int(_lib.ta_black_area(_u8p(a), a.size))


def shear_projections(img: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """Row projections of the column-sheared page for a batch of candidate
    angles; semantics = oracle.shear_projection per shifts row."""
    _build_and_load()
    a = _as_u8_ro(img)
    H, W = a.shape
    sh = np.ascontiguousarray(shifts, dtype=np.int32)
    A = sh.shape[0]
    assert sh.shape[1] == W
    proj = np.zeros((A, H), np.int64)
    _lib.ta_shear_projections(
        _u8p(a), H, W,
        sh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), A,
        proj.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return proj


def to_greyscale(img: np.ndarray) -> np.ndarray:
    """Exact oracle.to_greyscale (integer luminance, RGBA over white)."""
    _build_and_load()
    a = np.ascontiguousarray(img, dtype=np.uint8)
    if a.ndim == 2:
        return a.copy()
    H, W, C = a.shape
    if C not in (3, 4):  # same contract as oracle.to_greyscale
        raise ValueError(f"expected RGB/RGBA/grey image, got {C} channels")
    out = np.zeros((H, W), np.uint8)
    _lib.ta_greyscale(_u8p(a), H * W, C, _u8p(out))
    return out


def to_onebit(img: np.ndarray) -> np.ndarray:
    """Greyscale + Otsu binarization, oracle.to_onebit parity (the Otsu
    criterion itself runs on 256 host bins — cost-free)."""
    from . import oracle

    _build_and_load()
    grey = to_greyscale(img)
    hist = np.zeros(256, np.int64)
    _lib.ta_grey_histogram(_u8p(grey), grey.size,
                           hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    t = oracle.otsu_from_hist(hist)
    return grey <= t


def _rotate_u8(a: np.ndarray, angle_deg: float) -> np.ndarray:
    from . import fixedpoint as fxp

    H, W = a.shape
    H2, W2 = fxp.rotated_canvas(H, W, angle_deg)
    cfix, sfix = fxp.rotation_coeffs(angle_deg)
    out = np.zeros((H2, W2), np.uint8)
    _lib.ta_rotate_onebit(_u8p(a), H, W, H2, W2, cfix, sfix,
                          fxp.SCALE_BITS, _u8p(out))
    return out


def rotate_onebit(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Bit-identical native version of oracle.rotate_onebit (shared Q16
    fixed-point inverse map, symmetric canvas growth)."""
    _build_and_load()
    return _rotate_u8(_as_u8(img), angle_deg).astype(bool)


def _erode2_u8(a: np.ndarray) -> np.ndarray:
    out = np.empty_like(a)
    _lib.ta_erode2(_u8p(a), a.shape[0], a.shape[1], _u8p(out))
    return out


def erode2(img: np.ndarray) -> np.ndarray:
    """Fused filter_short_runs(2,'black') -> filter_narrow_runs(2,'black')
    (the preprocess erosion defaults): two streamed neighbor passes instead
    of a column-major run walk. Bit-parity tested vs the oracle filters."""
    _build_and_load()
    return _erode2_u8(_as_u8(img)).astype(bool)


def _adjacent_unique(shifts: np.ndarray):
    """Exact row dedup for a stack of shift vectors: neighboring candidate
    angles quantize to IDENTICAL Q16 shift vectors in the fine rounds, and
    shear_shifts is monotone in the angle, so equal rows are adjacent.
    Returns (unique rows, inverse index). Unlike np.unique(axis=0) this is
    one vectorized diff (np.unique lexsorts full rows — measured 5-7 ms per
    round, dwarfing the projection work itself)."""
    if len(shifts) == 1:
        return shifts, np.zeros(1, np.int64)
    new_row = np.empty(len(shifts), bool)
    new_row[0] = True
    new_row[1:] = np.any(shifts[1:] != shifts[:-1], axis=1)
    inv = np.cumsum(new_row) - 1
    return shifts[new_row], inv


def _black_runs(a: np.ndarray):
    """Extract the black runs of a uint8 page: (int32[3n] (y, xs, xe), n)."""
    H, W = a.shape
    max_n = max(1024, (H * W) // 8)  # run count << ink pixel count
    runs = np.empty(3 * max_n, np.int32)
    n = int(_lib.ta_black_runs(
        _u8p(a), H, W,
        runs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_n,
    ))
    if n > max_n:  # pathologically fragmented page: one exact retry
        max_n = n
        runs = np.empty(3 * max_n, np.int32)
        n = int(_lib.ta_black_runs(
            _u8p(a), H, W,
            runs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_n,
        ))
    return runs, n


def rotation_angle_projections(img: np.ndarray, minangle: float = -6.0,
                               maxangle: float = 6.0,
                               runs_n=None) -> float:
    """Coarse-to-fine skew estimate; same grid/criterion/first-max rule as
    oracle.rotation_angle_projections. All angle/shift math stays in
    Python (bit-identical grids); the native side extracts the black RUNS
    once and replays them per candidate angle — the shift ramp is constant
    across most runs, so a whole run costs one counter increment
    (bit-identical grouping of the per-pixel replay). ``runs_n`` supplies
    a precomputed (runs, n) pair (e.g. from the fused stage-1 pass) to
    skip the extraction scan."""
    from . import fixedpoint as fxp
    from .oracle import criterion_from_projections

    _build_and_load()
    a = _as_u8_ro(img)
    H, W = a.shape
    runs, n = runs_n if runs_n is not None else _black_runs(a)
    best, step, lo, hi = 0.0, 1.0, minangle, maxangle
    for _ in range(3):
        cands = fxp.angle_grid(lo, hi, step)
        shifts = np.ascontiguousarray(
            fxp.shear_shifts_batch(cands, W), np.int32
        )
        uniq, inv = _adjacent_unique(shifts)
        uniq = np.ascontiguousarray(uniq, np.int32)
        # int32 counters (zeroed native-side): counts are bounded by the
        # page's ink pixels, and the criterion widens to int64 — exact
        projs_u = np.empty((len(uniq), H), np.int32)
        _lib.ta_shear_projections_runs32(
            runs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(uniq), H, W,
            projs_u.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        scores = criterion_from_projections(projs_u)[inv]
        best = cands[int(np.argmax(scores))]
        lo, hi = best - step * 0.9, best + step * 0.9
        step /= 10.0
    return float(best)


def nearest_higher(data: np.ndarray):
    """(left, right) nearest strictly-higher neighbor indices of a float64
    series (left: largest j < i with data[j] > data[i], else -1; right:
    smallest j > i, else n). Exact float64 comparisons; the native twin of
    the Python monotonic stacks in ops/projections."""
    _build_and_load()
    a = np.ascontiguousarray(data, np.float64)
    n = len(a)
    left = np.empty(n, np.int32)
    right = np.empty(n, np.int32)
    _lib.ta_nearest_higher(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        left.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        right.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return left, right


def cc_stats_masked(img: np.ndarray, row_mask: np.ndarray,
                    max_ccs: int = 1 << 20):
    """cc_stats with rows where ``row_mask`` is set treated as white —
    the separator-erasure pass of identify_text_lines without copying the
    page (bit-identical to cc_stats on an erased copy; tested)."""
    _build_and_load()
    a = _as_u8_ro(img)
    m = _as_u8_ro(np.ascontiguousarray(row_mask))
    H, W = a.shape
    table = np.zeros((max_ccs, 5), np.int64)
    n = _lib.ta_cc_stats_masked(
        _u8p(a), H, W, _u8p(m),
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_ccs)
    if n > max_ccs:
        raise RuntimeError(f"page has {n} CCs > max_ccs={max_ccs}")
    return table[:n].copy()


def _greyscale_hist(input_image: np.ndarray):
    """Fused greyscale + 256-bin histogram (one pass over the colour
    buffer). Returns (grey uint8, hist int64[256])."""
    a = np.ascontiguousarray(input_image, dtype=np.uint8)
    hist = np.zeros(256, np.int64)
    if a.ndim == 2:
        _lib.ta_grey_histogram(
            _u8p(a), a.size,
            hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return a, hist
    H, W, C = a.shape
    if C not in (3, 4):  # same contract as oracle.to_greyscale
        raise ValueError(f"expected RGB/RGBA/grey image, got {C} channels")
    out = np.empty((H, W), np.uint8)
    _lib.ta_greyscale_hist(
        _u8p(a), H * W, C, _u8p(out),
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, hist


def _stage1_runs(a: np.ndarray, despeckle_amt: int, sat_area_thresh: int,
                 sat_area: bool = False):
    """In-place fused stage 1 on a uint8 page; returns the processed
    page's black runs (int32[3n], n) for reuse by skew/rotate.
    ``sat_area=True`` filters tall CCs by true pixel area (strict=False
    mode) instead of the reference's nrows quirk."""
    H, W = a.shape
    max_n = max(1024, (H * W) // 8)
    runs = np.empty(3 * max_n, np.int32)
    n = int(_lib.ta_preproc_stage1_runs(
        _u8p(a), H, W, despeckle_amt, sat_area_thresh,
        runs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_n,
        1 if sat_area else 0))
    if n > max_n:  # image is final; only the run export overflowed
        runs, n2 = _black_runs(a)
        n = n2
    return runs, n


def _rotate_runs_u8(runs: np.ndarray, n: int, H: int, W: int,
                    angle_deg: float) -> np.ndarray:
    """Rotate a run-encoded page (same Q16 map as _rotate_u8; the native
    kernel solves the inverse map per run interval). Requires cfix > 0 —
    the caller falls back to the pixel kernel otherwise (never happens
    within the +-6 deg skew range)."""
    from . import fixedpoint as fxp

    H2, W2 = fxp.rotated_canvas(H, W, angle_deg)
    cfix, sfix = fxp.rotation_coeffs(angle_deg)
    out = np.empty((H2, W2), np.uint8)
    _lib.ta_rotate_runs(
        runs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, H, W,
        H2, W2, cfix, sfix, fxp.SCALE_BITS, _u8p(out))
    return out


def preproc_stage1(img: np.ndarray, despeckle_amt: int,
                   sat_area_thresh: int,
                   sat_area: bool = False) -> np.ndarray:
    """Fused despeckle(black) -> despeckle(white) -> remove-tall in one
    native call (textAlignPreprocessing.py:166-178 semantics;
    ``sat_area=True`` = strict=False area filter)."""
    _build_and_load()
    a = _as_u8(img)
    _lib.ta_preproc_stage1(_u8p(a), a.shape[0], a.shape[1],
                           despeckle_amt, sat_area_thresh,
                           1 if sat_area else 0)
    return a.astype(bool)


def nw_fill(t_ids: np.ndarray, o_ids: np.ndarray, match: int, mismatch: int,
            gox: int, goy: int, gex: int, gey: int, boundary_ge: int):
    """Native Gotoh fill on token ids. Returns (mat_ptr, x_ptr, y_ptr)
    int8 (N, M) arrays, bit-identical to align.nw_host.fill_host_fast."""
    _build_and_load()
    t = np.ascontiguousarray(t_ids, np.int32)
    o = np.ascontiguousarray(o_ids, np.int32)
    N, M = len(t), len(o)
    mat_ptr = np.empty((N, M), np.int8)
    x_ptr = np.empty((N, M), np.int8)
    y_ptr = np.empty((N, M), np.int8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    _lib.ta_nw_fill(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), N,
        o.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), M,
        match, mismatch, gox, goy, gex, gey, boundary_ge,
        mat_ptr.ctypes.data_as(i8p), x_ptr.ctypes.data_as(i8p),
        y_ptr.ctypes.data_as(i8p),
    )
    return mat_ptr, x_ptr, y_ptr


def preprocess_page_phase1(input_image: np.ndarray, despeckle_amt: int,
                           sat_area_thresh: int, sat_area: bool = False):
    """Stage 1 of the preprocess raster chain (binarize -> despeckle x2 ->
    tall-CC removal), fused on uint8 buffers. Returns (img uint8 0/1,
    runs int32[3n], n_runs) — the run list feeds the skew search and the
    run-domain rotate, so no later stage pays a page-extraction scan."""
    from . import oracle

    _build_and_load()
    grey, hist = _greyscale_hist(input_image)
    t = oracle.otsu_from_hist(hist)
    # fused binarize + stage 1: runs come straight off the greyscale page
    # (the binarized intermediate is never materialized)
    img = np.empty_like(grey)
    H, W = grey.shape
    max_n = max(1024, (H * W) // 8)
    runs = np.empty(3 * max_n, np.int32)
    n_runs = int(_lib.ta_preproc_grey_stage1_runs(
        _u8p(grey), H, W, int(t), despeckle_amt, sat_area_thresh,
        _u8p(img),
        runs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_n,
        1 if sat_area else 0))
    if n_runs > max_n:  # image is final; only the run export overflowed
        runs, n_runs = _black_runs(img)
    return img, runs, n_runs


def preprocess_page_phase2(img: np.ndarray, runs: np.ndarray, n_runs: int,
                           angle: float, filter_runs: int,
                           filter_runs_amt: int, correct_rotation: bool):
    """Rotate + erode tail of the preprocess chain, given the detected
    ``angle`` (from the host search or ops.skew_device's accelerator
    search — bit-identical either way). Consumes phase 1's (img, runs).
    Returns (image_bin bool, image_eroded bool)."""
    from . import fixedpoint as fxp

    if correct_rotation:
        cfix, _ = fxp.rotation_coeffs(angle)
        if cfix > 0:
            img = _rotate_runs_u8(runs, n_runs, img.shape[0],
                                  img.shape[1], angle)
        else:  # unreachable within the +-6 deg search range
            img = _rotate_u8(img, angle)
    eroded = img
    for _ in range(filter_runs):
        if filter_runs_amt == 2:
            eroded = _erode2_u8(eroded)
        else:
            eroded = eroded.copy() if eroded is img else eroded
            _lib.ta_filter_runs(_u8p(eroded), eroded.shape[0],
                                eroded.shape[1], filter_runs_amt, 1, 0)
            _lib.ta_filter_runs(_u8p(eroded), eroded.shape[0],
                                eroded.shape[1], filter_runs_amt, 1, 1)
    if eroded is img:  # filter_runs == 0
        eroded = img.copy()
    # every buffer here is freshly allocated and strictly 0/1 (binarize
    # output propagated through despeckle/rotate/erode), so reinterpreting
    # as bool is free and canonical
    return img.view(bool), eroded.view(bool)


def pack_runs_into(runs: np.ndarray, n: int, dest_u8: np.ndarray) -> None:
    """OR the run list's ink bits (little-endian np.packbits layout) into a
    PRE-ZEROED 2-D uint8 buffer — the skew upload pack without re-reading
    the 0/1 page (ops/skew_device.py rides phase 1's exported runs)."""
    _build_and_load()
    assert dest_u8.dtype == np.uint8 and dest_u8.flags.c_contiguous
    _lib.ta_pack_runs_into(
        runs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        _u8p(dest_u8), dest_u8.strides[0])


def rotate_runs2(runs: np.ndarray, n: int, H: int, W: int,
                 angle_deg: float):
    """Rotate a run-encoded page; returns (img uint8 (H2, W2), out_runs
    int32[3m], m) where out_runs are the rotated page's maximal black runs
    (bit-identical to re-extracting them from img, without the scan)."""
    from . import fixedpoint as fxp

    _build_and_load()
    H2, W2 = fxp.rotated_canvas(H, W, angle_deg)
    cfix, sfix = fxp.rotation_coeffs(angle_deg)
    out = np.empty((H2, W2), np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    max_m = 2 * n + H2 + 1024
    out_runs = np.empty(3 * max_m, np.int32)
    m = int(_lib.ta_rotate_runs2(
        runs.ctypes.data_as(i32p), n, H, W, H2, W2, cfix, sfix,
        fxp.SCALE_BITS, _u8p(out), out_runs.ctypes.data_as(i32p), max_m))
    if m > max_m:  # img is final; only the run export overflowed
        out_runs = np.empty(3 * m, np.int32)
        _lib.ta_rotate_runs2(
            runs.ctypes.data_as(i32p), n, H, W, H2, W2, cfix, sfix,
            fxp.SCALE_BITS, _u8p(out), out_runs.ctypes.data_as(i32p), m)
    return out, out_runs, m


def erode_runs(runs: np.ndarray, n: int, H: int):
    """Run-domain erode2 (filter short + narrow runs of 2). Returns
    (eroded_runs int32[3m], m, proj int64[H]) where proj is the eroded
    page's row projection — both bit-identical to the pixel path."""
    _build_and_load()
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    proj = np.empty(H, np.int64)
    max_m = 3 * n + 16
    out = np.empty(3 * max_m, np.int32)
    m = int(_lib.ta_erode_runs(runs.ctypes.data_as(i32p), n, H,
                               out.ctypes.data_as(i32p), max_m,
                               proj.ctypes.data_as(i64p)))
    assert m <= max_m, "erode_runs output bound violated"
    return out, m, proj


def cc_stats_from_runs(runs: np.ndarray, n: int, H: int,
                       row_mask: np.ndarray | None,
                       max_ccs: int = 1 << 20):
    """cc_stats over a run-encoded page with masked rows dropped — the
    run-domain twin of cc_stats_masked (same table, same scan order)."""
    _build_and_load()
    i32p = ctypes.POINTER(ctypes.c_int32)
    mask = (np.ascontiguousarray(row_mask, np.uint8) if row_mask is not None
            else np.zeros(H, np.uint8))
    table = np.zeros((max_ccs, 5), np.int64)
    k = int(_lib.ta_cc_stats_from_runs(
        runs.ctypes.data_as(i32p), n, H, _u8p(mask),
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_ccs))
    if k > max_ccs:
        raise RuntimeError(f"page has {k} CCs > max_ccs={max_ccs}")
    return table[:k].copy()


def preprocess_page_phase2_runs(img: np.ndarray, runs: np.ndarray,
                                n_runs: int, angle: float,
                                correct_rotation: bool,
                                want_packed: bool = False):
    """Fused run-domain phase 2 for the streamed batched raster: rotate
    (pixels + runs in one pass), erode in run domain, and emit the eroded
    row projection — the eroded pixel page is NEVER materialized. Only
    supports the pipeline's standard erode (filter_runs=1, amt=2; callers
    needing other shapes use preprocess_page_phase2). Returns
    (image_bin bool, eroded_runs int32[3m], m, proj int64[H2]) and, with
    ``want_packed=True``, a fifth element: the ROTATED binarized page as
    (H2, ceil(W2/32)) int32 little-endian bit rows (packed straight from
    the rotated run list, O(ink/8) — the packed-page OCR feed uploads
    this instead of per-strip crops)."""
    from . import fixedpoint as fxp

    H, W = img.shape
    if correct_rotation:
        cfix, _ = fxp.rotation_coeffs(angle)
        if cfix > 0:
            img_u8, rruns, rn = rotate_runs2(runs, n_runs, H, W, angle)
        else:  # unreachable within the +-6 deg search range
            img_u8 = _rotate_u8(img, angle)
            rruns, rn = _black_runs(img_u8)
    else:
        img_u8, rruns, rn = img, runs, n_runs
    eruns, en, proj = erode_runs(rruns, rn, img_u8.shape[0])
    image_bin = img_u8.view(bool) if img_u8.dtype == np.uint8 else img_u8
    if not want_packed:
        return image_bin, eruns, en, proj
    H2, W2 = image_bin.shape
    bits8 = np.zeros((H2, -(-W2 // 32) * 4), np.uint8)
    pack_runs_into(rruns, rn, bits8)
    return image_bin, eruns, en, proj, bits8.view(np.int32)


def preprocess_page(input_image: np.ndarray, despeckle_amt: int,
                    sat_area_thresh: int, filter_runs: int,
                    filter_runs_amt: int, correct_rotation: bool,
                    sat_area: bool = False):
    """Whole preprocess_images raster chain (binarize -> stage1 -> skew ->
    rotate -> erode) on uint8 buffers end to end: one bool conversion per
    returned page instead of two 3 MB bool<->u8 copies around every native
    call. Stage semantics identical to the staged calls (tested).

    Returns (image_bin bool, image_eroded bool, angle).
    """
    img, runs, n_runs = preprocess_page_phase1(input_image, despeckle_amt,
                                               sat_area_thresh, sat_area)
    angle = rotation_angle_projections(img, -6, 6, runs_n=(runs, n_runs))
    image_bin, image_eroded = preprocess_page_phase2(
        img, runs, n_runs, angle, filter_runs, filter_runs_amt,
        correct_rotation)
    return image_bin, image_eroded, float(angle)
