"""Device raster kernels (JAX/XLA), bit-exact against :mod:`.oracle`.

Design notes (data-parallel, not a Gamera translation):

- Pages are dense bool/int tensors; per-CC "views" become whole-image label
  maps plus scatter/gather statistics (no object soup).
- Connected components: Shiloach–Vishkin-style label propagation — each
  pixel's label is the min flat index reachable; per iteration one
  8-neighbor hooking step plus two pointer-jumping steps (gathers), under a
  bounded ``lax.while_loop`` with fixpoint early-exit. Root labels are the
  component's min flat index, so compacted tables come out in the same order
  as the host oracle's scan-order labels.
- Run filters: last-white/next-white cumulative scans (log-depth), no
  sequential loops.
- Skew/rotation: the shared integer fixed-point formulas in
  :mod:`.fixedpoint`; trig is evaluated host-side in float64 and shipped as
  Q16 integers, so host and device rotations agree pixel-for-pixel.
- Criterion sums that overflow int32 are returned as small per-row tensors
  and reduced on host in int64 — keeping device math exact.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import fixedpoint as fxp
from . import oracle

MAX_CCS = 4096
_CC_MAX_ITERS = 192


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------

def _segmin_scan(vals, img, axis, reverse):
    """Segmented running min of ``vals`` along ``axis`` within runs of black
    pixels (white resets the segment). Associative scan — log-depth, fully
    vectorized, no gathers."""
    boundary = ~img  # a white pixel starts a new segment

    def combine(a, b):
        av, ab = a
        bv, bb = b
        return jnp.where(bb, bv, jnp.minimum(av, bv)), ab | bb

    out, _ = jax.lax.associative_scan(
        combine, (vals, boundary), axis=axis, reverse=reverse
    )
    return out


def _run_min(vals, img, axis):
    """Min label over each pixel's full run along ``axis``."""
    fwd = _segmin_scan(vals, img, axis, reverse=False)
    bwd = _segmin_scan(vals, img, axis, reverse=True)
    return jnp.minimum(fwd, bwd)


@functools.partial(jax.jit, static_argnames=("max_iters",))
def cc_label(img, max_iters=_CC_MAX_ITERS):
    """8-connected labeling. Returns int32 (H, W) where each black pixel
    holds its component's min flat index and white pixels hold H*W.

    Run-based propagation: each iteration takes the min over the
    8-neighborhood (shift passes), then spreads labels across entire
    horizontal and vertical runs via segmented min-scans. A label crosses a
    whole run per step, so convergence takes roughly the number of "turns"
    in a component's shape (a handful for glyphs), not its pixel diameter —
    and nothing ever gathers."""
    H, W = img.shape
    INF = jnp.int32(H * W)
    flat = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    lbl0 = jnp.where(img, flat, INF)

    def nbr_min(l):
        p = jnp.pad(l, 1, constant_values=INF)
        best = l
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                best = jnp.minimum(best, p[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W])
        return jnp.where(img, best, INF)

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        lbl, _, it = state
        new = jnp.minimum(lbl, nbr_min(lbl))
        new = _run_min(new, img, axis=1)
        new = _run_min(new, img, axis=0)
        new = jnp.where(img, new, INF)
        return new, jnp.any(new != lbl), it + 1

    lbl, _, _ = jax.lax.while_loop(cond, body, (lbl0, jnp.bool_(True), jnp.int32(0)))
    return lbl


def _scatter_stats(img, lbl):
    """Per-root (area, rmin, rmax, cmin, cmax) flat arrays of size H*W+1."""
    H, W = img.shape
    INF = jnp.int32(H * W)
    f = lbl.reshape(-1)
    blk = img.reshape(-1)
    ones = blk.astype(jnp.int32)
    rows = jnp.broadcast_to(jnp.arange(H, dtype=jnp.int32)[:, None], (H, W)).reshape(-1)
    cols = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (H, W)).reshape(-1)
    big = jnp.where(blk, rows, INF)
    small = jnp.where(blk, rows, -1)
    bigc = jnp.where(blk, cols, INF)
    smallc = jnp.where(blk, cols, -1)

    size = H * W + 1
    area = jnp.zeros(size, jnp.int32).at[f].add(ones)
    rmin = jnp.full(size, INF, jnp.int32).at[f].min(big)
    rmax = jnp.full(size, -1, jnp.int32).at[f].max(small)
    cmin = jnp.full(size, INF, jnp.int32).at[f].min(bigc)
    cmax = jnp.full(size, -1, jnp.int32).at[f].max(smallc)
    return area, rmin, rmax, cmin, cmax


@functools.partial(jax.jit, static_argnames=("max_ccs",))
def cc_stats_compact(img, max_ccs=MAX_CCS):
    """Compact per-CC stats table, ordered by min flat index (same order as
    the oracle's scan-order labels). Returns (table int32 (max_ccs, 5) with
    columns (uly, lry, ulx, lrx, area), count). Rows past ``count`` are
    invalid (area 0)."""
    lbl = cc_label(img)
    area, rmin, rmax, cmin, cmax = _scatter_stats(img, lbl)
    H, W = img.shape
    present = area > 0
    count = jnp.sum(present.astype(jnp.int32))
    roots = jnp.nonzero(present, size=max_ccs, fill_value=H * W)[0]
    table = jnp.stack(
        [rmin[roots], rmax[roots], cmin[roots], cmax[roots], area[roots]], axis=1
    )
    return table, count


@jax.jit
def despeckle(img, k):
    """Remove black CCs with area <= k (oracle.despeckle parity)."""
    lbl = cc_label(img)
    area, *_ = _scatter_stats(img, lbl)
    return img & (area[lbl] > k)


@jax.jit
def remove_small_ccs(img, min_area):
    """fill_white CCs with area < min_area."""
    lbl = cc_label(img)
    area, *_ = _scatter_stats(img, lbl)
    return img & (area[lbl] >= min_area)


@jax.jit
def remove_tall_ccs(img, max_nrows):
    """fill_white CCs whose row count exceeds max_nrows (the reference's
    nrows-as-area quirk, textAlignPreprocessing.py:174-178)."""
    lbl = cc_label(img)
    _, rmin, rmax, _, _ = _scatter_stats(img, lbl)
    nrows = rmax[lbl] - rmin[lbl] + 1
    return img & ~(nrows > max_nrows)


@jax.jit
def remove_big_ccs(img, max_area):
    """fill_white CCs whose true pixel AREA exceeds max_area — the
    strict=False corrected form of :func:`remove_tall_ccs`
    (oracle.remove_big_ccs parity; the reference's comment says "area"
    but its code counts rows, textAlignPreprocessing.py:174-178)."""
    lbl = cc_label(img)
    area, *_ = _scatter_stats(img, lbl)
    return img & ~(area[lbl] > max_area)


# ---------------------------------------------------------------------------
# run filters
# ---------------------------------------------------------------------------

def _run_length_map_axis0(img):
    """Length of the vertical run through each pixel, via last-white /
    next-white cumulative extrema (log-depth, no sequential loop)."""
    H, W = img.shape
    idx = jnp.broadcast_to(jnp.arange(H, dtype=jnp.int32)[:, None], (H, W))
    white = ~img
    lz = jax.lax.cummax(jnp.where(white, idx, -1), axis=0)
    nz = jnp.flip(
        jax.lax.cummin(jnp.flip(jnp.where(white, idx, H), axis=0), axis=0), axis=0
    )
    return nz - lz - 1


def filter_runs_impl(img, k, color, axis):
    target = img if color == "black" else ~img
    t = target if axis == 0 else target.T
    lens = _run_length_map_axis0(t)
    keep = t & (lens >= k)
    keep = keep if axis == 0 else keep.T
    return keep if color == "black" else ~keep


@functools.partial(jax.jit, static_argnames=("color", "axis"))
def filter_runs(img, k, color="black", axis=0):
    """Remove runs of ``color`` along ``axis`` with length < k.
    axis=0 == Gamera filter_short_runs; axis=1 == filter_narrow_runs."""
    return filter_runs_impl(img, k, color, axis)


def filter_short_runs(img, k, color="black"):
    return filter_runs(img, k, color=color, axis=0)


def filter_narrow_runs(img, k, color="black"):
    return filter_runs(img, k, color=color, axis=1)


# ---------------------------------------------------------------------------
# binarization / projections / drawing
# ---------------------------------------------------------------------------

@jax.jit
def grey_histogram(grey):
    return jnp.zeros(256, jnp.int32).at[grey.reshape(-1).astype(jnp.int32)].add(1)


@jax.jit
def to_greyscale(rgb):
    """Integer luminance identical to oracle.to_greyscale."""
    rgb = rgb.astype(jnp.int32)
    if rgb.ndim == 2:
        return rgb.astype(jnp.uint8)
    if rgb.shape[2] not in (3, 4):  # same contract as oracle/native
        raise ValueError(
            f"expected RGB/RGBA/grey image, got {rgb.shape[2]} channels"
        )
    if rgb.shape[2] == 4:
        a = rgb[..., 3]
        rgb = (rgb[..., :3] * a[..., None] + 255 * (255 - a)[..., None] + 127) // 255
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return ((299 * r + 587 * g + 114 * b + 500) // 1000).astype(jnp.uint8)


def to_onebit(img):
    """Greyscale + Otsu. The 256-bin histogram is reduced on device; the
    (cheap, float64) threshold criterion runs on host for exact parity with
    the oracle."""
    grey = to_greyscale(jnp.asarray(img))
    hist = np.asarray(grey_histogram(grey))
    t = _otsu_from_hist(hist)
    return grey <= t


def _otsu_from_hist(hist):
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 127
    omega = np.cumsum(hist)
    mu = np.cumsum(hist * np.arange(256))
    mu_t = mu[-1]
    w0, w1 = omega, total - omega
    valid = (w0 > 0) & (w1 > 0)
    num = (mu_t * w0 - mu * total) ** 2
    sigma_b = np.zeros(256)
    sigma_b[valid] = num[valid] / (w0[valid] * w1[valid])
    return int(np.argmax(sigma_b))


@jax.jit
def projection_rows(img):
    return jnp.sum(img.astype(jnp.int32), axis=1)


@jax.jit
def erase_rows(img, row_mask):
    """White-out the rows where row_mask (H,) is True (separator lines)."""
    return img & ~row_mask[:, None]


# ---------------------------------------------------------------------------
# bit packing (device->host page transfers)
# ---------------------------------------------------------------------------
# A onebit page crosses between host and device 8x smaller as a bitmask.

def _packed_width(W: int) -> int:
    return (W + 31) // 32


@jax.jit
def pack_bool(img):
    """(H, W) bool -> (H, ceil(W/32)) int32 bitmask (little-endian bits)."""
    H, W = img.shape
    Wp = _packed_width(W) * 32
    x = jnp.pad(img, ((0, 0), (0, Wp - W))).reshape(H, Wp // 32, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    packed = jnp.sum(x.astype(jnp.uint32) * weights, axis=2)
    return packed.astype(jnp.int32)


def unpack_bool(packed: np.ndarray, W: int) -> np.ndarray:
    """Host-side inverse of pack_bool."""
    packed = np.asarray(packed).astype(np.uint32)
    H = packed.shape[0]
    bits = (packed[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(H, -1)[:, :W].astype(bool)


def get_bool(img_dev) -> np.ndarray:
    """Download a device bool image via the packed path."""
    W = int(img_dev.shape[1])
    return unpack_bool(np.asarray(pack_bool(img_dev)), W)


# ---------------------------------------------------------------------------
# fused preprocessing stages (one dispatch each; pages stay on device)
# ---------------------------------------------------------------------------

@jax.jit
def binarize(grey, thresh):
    return grey <= thresh


@jax.jit
def despeckle_white(img, k):
    """Remove white CCs with area <= k (the reference's
    invert-despeckle-invert, textAlignPreprocessing.py:169-171)."""
    inv = ~img
    lbl = cc_label(inv)
    area, *_ = _scatter_stats(inv, lbl)
    return ~(inv & (area[lbl] > k))


def preproc_stage1(grey, thresh, despeckle_amt, sat_area_thresh,
                   sat_by_area: bool = False):
    """binarize -> despeckle(black) -> despeckle(white) -> remove tall CCs
    (textAlignPreprocessing.py:166-178). Four small dispatches — page
    tensors stay on device between them; the per-op programs compile far
    faster (remote compile cost grows superlinearly with program size) and
    their jit cache entries are reusable by other callers.
    ``sat_by_area=True`` = the strict=False corrected area filter."""
    img = binarize(grey, thresh)
    img = despeckle(img, despeckle_amt)
    img = despeckle_white(img, despeckle_amt)
    if sat_by_area:
        return remove_big_ccs(img, sat_area_thresh)
    return remove_tall_ccs(img, sat_area_thresh)


@functools.partial(
    jax.jit, static_argnames=("H2", "W2", "filter_runs", "filter_runs_amt")
)
def rotate_erode_project(img, cfix, sfix, H2, W2, filter_runs,
                         filter_runs_amt):
    """rotate -> run-filter erosion -> row projection
    (textAlignPreprocessing.py:185-193, :211) in a single dispatch. Returns
    (packed binarized page, packed eroded page, projection)."""
    rot = _rotate_gather_body(img, cfix, sfix, H2, W2)
    eroded = rot
    for _ in range(filter_runs):
        eroded = filter_runs_impl(eroded, filter_runs_amt, "black", 0)
        eroded = filter_runs_impl(eroded, filter_runs_amt, "black", 1)
    proj = jnp.sum(eroded.astype(jnp.int32), axis=1)
    return pack_bool(rot), pack_bool(eroded), proj


@functools.partial(jax.jit, static_argnames=("max_ccs",))
def erase_and_ccstats(eroded, row_mask, max_ccs=MAX_CCS):
    """separator erase + CC stats table in a single dispatch."""
    img = eroded & ~row_mask[:, None]
    lbl = cc_label(img)
    area, rmin, rmax, cmin, cmax = _scatter_stats(img, lbl)
    H, W = img.shape
    present = area > 0
    count = jnp.sum(present.astype(jnp.int32))
    roots = jnp.nonzero(present, size=max_ccs, fill_value=H * W)[0]
    table = jnp.stack(
        [rmin[roots], rmax[roots], cmin[roots], cmax[roots], area[roots]],
        axis=1,
    )
    return table, count


# ---------------------------------------------------------------------------
# skew detection + rotation
# ---------------------------------------------------------------------------

@jax.jit
def shear_projections(img, shifts):
    """Row projections of the column-sheared image for each candidate angle.
    shifts: (A, W) int32 from fixedpoint.shear_shifts. Returns (A, H) int32;
    the (overflow-prone) squared-derivative criterion is reduced on host."""
    H, W = img.shape
    x = img.astype(jnp.int32)

    def one(sh):
        ys = jnp.arange(H, dtype=jnp.int32)[:, None] + sh[None, :]
        valid = (ys >= 0) & (ys < H)
        ysc = jnp.clip(ys, 0, H - 1)
        g = jnp.take_along_axis(x, ysc, axis=0) * valid
        return jnp.sum(g, axis=1)

    return jax.vmap(one)(shifts)


criterion_from_projections = oracle.criterion_from_projections


def rotation_angle_projections(img, minangle=-6.0, maxangle=6.0):
    """Coarse-to-fine skew estimate (same grid/criterion as the oracle)."""
    img = jnp.asarray(img)
    W = int(img.shape[1])
    best, step, lo, hi = 0.0, 1.0, minangle, maxangle
    for _ in range(3):
        cands = fxp.angle_grid(lo, hi, step)
        shifts = fxp.shear_shifts_batch(cands, W)
        projs = np.asarray(shear_projections(img, jnp.asarray(shifts)))
        scores = criterion_from_projections(projs)
        best = cands[int(np.argmax(scores))]
        lo, hi = best - step * 0.9, best + step * 0.9
        step /= 10.0
    return float(best)


def _rotate_gather_body(img, cfix, sfix, H2, W2):
    H, W = img.shape
    x2 = jnp.arange(W2, dtype=jnp.int32)[None, :]
    y2 = jnp.arange(H2, dtype=jnp.int32)[:, None]
    dx2 = 2 * x2 - (W2 - 1)
    dy2 = 2 * y2 - (H2 - 1)
    sx2 = cfix * dx2 + sfix * dy2
    sy2 = -sfix * dx2 + cfix * dy2
    S, SB = fxp.SCALE, fxp.SCALE_BITS
    src_x = (sx2 + (W - 1) * S + S) >> (SB + 1)
    src_y = (sy2 + (H - 1) * S + S) >> (SB + 1)
    valid = (src_y >= 0) & (src_y < H) & (src_x >= 0) & (src_x < W)
    syc = jnp.clip(src_y, 0, H - 1)
    sxc = jnp.clip(src_x, 0, W - 1)
    return img[syc, sxc] & valid


_rotate_gather = jax.jit(_rotate_gather_body, static_argnames=("H2", "W2"))


def rotate_onebit(img, angle_deg: float):
    """Rotate about center onto an expanded white canvas; bit-identical to
    oracle.rotate_onebit."""
    H, W = int(img.shape[0]), int(img.shape[1])
    H2, W2 = fxp.rotated_canvas(H, W, angle_deg)
    cfix, sfix = fxp.rotation_coeffs(angle_deg)
    return _rotate_gather(
        jnp.asarray(img), jnp.int32(cfix), jnp.int32(sfix), H2, W2
    )
