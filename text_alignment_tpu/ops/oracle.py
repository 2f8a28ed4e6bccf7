"""Host (numpy/scipy) raster engine — the canonical semantics oracle.

The reference delegates all raster work to Gamera 3.4.3 C++ plugins
(SURVEY.md §2.9; call sites in textAlignPreprocessing.py:160-285). Gamera is
not runnable here, so this module *defines* the canonical semantics of each
operation for the new framework; the device kernels in ``ops.device`` are tested
bit-exactly against it. Where Gamera's exact behavior is ambiguous from its
docs, the choice is documented inline.

Conventions:
- a onebit image is a 2-D bool array, ``True`` = black (ink);
- coordinates follow Gamera: x = column, y = row; bboxes are
  (ulx, uly, lrx, lry) inclusive;
- all angle math that must match the device path uses the shared
  fixed-point integer formulation in :mod:`.fixedpoint`.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from . import fixedpoint as fxp

# 8-connectivity, as used by Gamera's cc_analysis
_STRUCT8 = np.ones((3, 3), dtype=bool)


# ---------------------------------------------------------------------------
# binarization
# ---------------------------------------------------------------------------

def to_greyscale(rgb: np.ndarray) -> np.ndarray:
    """RGB(A) uint8 -> greyscale uint8 with exact integer luminance
    ``(299 R + 587 G + 114 B + 500) // 1000``. Alpha, if present, is
    composited over white first (text layers are rgba+png,
    textAlignment.py:31)."""
    rgb = np.asarray(rgb)
    if rgb.ndim == 2:
        return rgb.astype(np.uint8)
    if rgb.shape[2] not in (3, 4):  # same contract as the native engine
        raise ValueError(
            f"expected RGB/RGBA/grey image, got {rgb.shape[2]} channels"
        )
    rgb = rgb.astype(np.int32)
    if rgb.shape[2] == 4:
        a = rgb[..., 3]
        rgb = (rgb[..., :3] * a[..., None] + 255 * (255 - a)[..., None] + 127) // 255
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return ((299 * r + 587 * g + 114 * b + 500) // 1000).astype(np.uint8)


def otsu_threshold(grey: np.ndarray) -> int:
    """Otsu threshold over the exact 256-bin histogram (float64 criterion).
    Returns t; black = grey <= t."""
    return otsu_from_hist(np.bincount(grey.reshape(-1), minlength=256))


def otsu_from_hist(hist) -> int:
    """Otsu criterion from a 256-bin histogram (shared by the numpy, native,
    and device binarization paths)."""
    hist = np.asarray(hist).astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 127
    omega = np.cumsum(hist)
    mu = np.cumsum(hist * np.arange(256))
    mu_t = mu[-1]
    w0 = omega
    w1 = total - omega
    valid = (w0 > 0) & (w1 > 0)
    num = (mu_t * w0 - mu * total) ** 2
    sigma_b = np.zeros(256)
    sigma_b[valid] = num[valid] / (w0[valid] * w1[valid])
    return int(np.argmax(sigma_b))


def to_onebit(img: np.ndarray) -> np.ndarray:
    """Gamera ``to_onebit`` equivalent (textAlignPreprocessing.py:166):
    greyscale + Otsu; pixels at or below threshold are black."""
    grey = to_greyscale(img)
    t = otsu_threshold(grey)
    return grey <= t


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------

def label_ccs(img: np.ndarray):
    """8-connected labeling. Returns (labels int32 array, n)."""
    labels, n = ndimage.label(img, structure=_STRUCT8)
    return labels.astype(np.int32), int(n)


def cc_stats(img: np.ndarray):
    """Per-CC stats table: columns (uly, lry, ulx, lrx, area), one row per
    component, ordered by label id. Equivalent information to Gamera's
    cc_analysis views (offset_y = uly, nrows = lry - uly + 1, black_area)."""
    labels, n = label_ccs(img)
    if n == 0:
        return labels, np.zeros((0, 5), dtype=np.int64)
    area = np.bincount(labels.reshape(-1), minlength=n + 1)[1:]
    objs = ndimage.find_objects(labels, max_label=n)
    table = np.zeros((n, 5), dtype=np.int64)
    for k, sl in enumerate(objs):
        ys, xs = sl
        table[k] = (ys.start, ys.stop - 1, xs.start, xs.stop - 1, area[k])
    return labels, table


def despeckle(img: np.ndarray, k: int) -> np.ndarray:
    """Remove black CCs with area <= k (Gamera ``despeckle(k)``,
    textAlignPreprocessing.py:168; despeckle(1) removes isolated pixels)."""
    labels, n = label_ccs(img)
    if n == 0:
        return img.copy()
    area = np.bincount(labels.reshape(-1), minlength=n + 1)
    keep = area > k
    keep[0] = False
    return keep[labels]


def remove_tall_ccs(img: np.ndarray, max_nrows: int) -> np.ndarray:
    """fill_white every CC whose row count exceeds ``max_nrows``
    (reference: ``area = c.nrows; if sat_area_thresh < area: c.fill_white()``
    — the 'area' is actually a row count, textAlignPreprocessing.py:174-178;
    quirk preserved)."""
    labels, table = cc_stats(img)
    if len(table) == 0:
        return img.copy()
    nrows = table[:, 1] - table[:, 0] + 1
    keep = np.ones(len(table) + 1, dtype=bool)
    keep[1:] = ~(nrows > max_nrows)
    keep[0] = False
    return keep[labels] & img


def remove_big_ccs(img: np.ndarray, max_area: int) -> np.ndarray:
    """fill_white every CC whose true pixel AREA exceeds ``max_area`` —
    the strict=False corrected form of :func:`remove_tall_ccs` (the
    reference's comment says "area" but its code counts rows,
    textAlignPreprocessing.py:174-178; parity mode keeps the quirk)."""
    labels, n = label_ccs(img)
    if n == 0:
        return img.copy()
    area = np.bincount(labels.reshape(-1), minlength=n + 1)
    keep = ~(area > max_area)
    keep[0] = False
    return keep[labels] & img


def remove_small_ccs(img: np.ndarray, min_area: int) -> np.ndarray:
    """fill_white every CC with area < min_area
    (textAlignPreprocessing.py:231-233)."""
    labels, n = label_ccs(img)
    if n == 0:
        return img.copy()
    area = np.bincount(labels.reshape(-1), minlength=n + 1)
    keep = area >= min_area
    keep[0] = False
    return keep[labels]


# ---------------------------------------------------------------------------
# run filters
# ---------------------------------------------------------------------------

def _run_length_map(img: np.ndarray, axis: int) -> np.ndarray:
    """Length of the black run through each black pixel along ``axis``
    (0 = vertical runs, 1 = horizontal runs). Fully vectorized via globally
    numbered runs."""
    a = img if axis == 0 else img.T
    H, W = a.shape
    x = a.astype(np.int64)
    # run starts down each column
    starts = np.vstack([x[0:1], (np.diff(x, axis=0) == 1).astype(np.int64)])
    rid = np.cumsum(starts, axis=0)  # per-column 1-based run index
    runs_per_col = starts.sum(axis=0)
    offsets = np.concatenate([[0], np.cumsum(runs_per_col)[:-1]])
    gid = (rid + offsets[None, :]) * x  # 0 where white, global run id where black
    total_runs = int(runs_per_col.sum())
    lens = np.bincount(gid.reshape(-1), minlength=total_runs + 1)
    out = (lens[gid] * x).astype(np.int32)
    return out if axis == 0 else out.T


def filter_short_runs(img: np.ndarray, k: int, color: str = "black") -> np.ndarray:
    """Remove vertical runs of ``color`` shorter than k pixels (run length
    < k), Gamera ``filter_short_runs`` (textAlignPreprocessing.py:192).
    Removing a black run turns it white and vice versa."""
    target = img if color == "black" else ~img
    lens = _run_length_map(target, axis=0)
    removed = target & (lens < k)
    result = target & ~removed
    return result if color == "black" else ~result


def filter_narrow_runs(img: np.ndarray, k: int, color: str = "black") -> np.ndarray:
    """Remove horizontal runs of ``color`` narrower than k pixels
    (textAlignPreprocessing.py:193)."""
    target = img if color == "black" else ~img
    lens = _run_length_map(target, axis=1)
    removed = target & (lens < k)
    result = target & ~removed
    return result if color == "black" else ~result


# ---------------------------------------------------------------------------
# projections / misc
# ---------------------------------------------------------------------------

def projection_rows(img: np.ndarray) -> np.ndarray:
    """Black count per row (Gamera projection_rows,
    textAlignPreprocessing.py:211)."""
    return img.sum(axis=1).astype(np.int64)


def black_area(img: np.ndarray) -> int:
    return int(img.sum())


def draw_hline_white(img: np.ndarray, row: int, thickness: int = 2) -> np.ndarray:
    """White horizontal line across the page at ``row``, covering
    ``thickness`` rows starting at ``row`` (reference draw_line with
    thickness 2, textAlignPreprocessing.py:224)."""
    out = img.copy()
    out[row : row + thickness, :] = False
    return out


def subimage(img: np.ndarray, ul, lr) -> np.ndarray:
    """Inclusive-bounds crop, Gamera subimage((ulx,uly),(lrx,lry))."""
    ulx, uly = ul
    lrx, lry = lr
    return img[uly : lry + 1, ulx : lrx + 1]


# ---------------------------------------------------------------------------
# skew detection + rotation (fixed-point shared with the device path)
# ---------------------------------------------------------------------------

def shear_projection(img: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """Row projection of the column-sheared image (each column x shifted
    vertically by shifts[x])."""
    H, W = img.shape
    ys = np.arange(H)[:, None] + shifts[None, :]
    valid = (ys >= 0) & (ys < H)
    ys = np.clip(ys, 0, H - 1)
    sheared = np.take_along_axis(img, ys, axis=0) & valid
    return sheared.sum(axis=1).astype(np.int64)


def criterion_from_projections(projs: np.ndarray) -> np.ndarray:
    """Skew criterion per candidate: sum of squared derivative of the row
    projection (larger = sharper line structure). Exact int64; shared by the
    host and device skew paths."""
    projs = np.asarray(projs, dtype=np.int64)
    d = np.diff(projs, axis=-1)
    return (d * d).sum(axis=-1)


def rotation_angle_projections(img: np.ndarray, minangle: float = -6.0,
                               maxangle: float = 6.0) -> float:
    """Estimate page skew by maximizing the shear-projection criterion over
    a coarse-to-fine angle grid (1.0 -> 0.1 -> 0.01 degrees), equivalent in
    role to Gamera rotation_angle_projections(-6, 6)
    (textAlignPreprocessing.py:183). First-max wins at each stage."""
    W = img.shape[1]
    best = 0.0
    step = 1.0
    lo, hi = minangle, maxangle
    for _ in range(3):
        cands = fxp.angle_grid(lo, hi, step)
        shifts = fxp.shear_shifts_batch(cands, W)
        projs = np.stack(
            [shear_projection(img, s) for s in shifts]
        )
        scores = criterion_from_projections(projs)
        best = cands[int(np.argmax(scores))]
        lo, hi = best - step * 0.9, best + step * 0.9
        step /= 10.0
    return float(best)


def rotate_onebit(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate a onebit image by ``angle_deg`` about its center onto an
    expanded white canvas (nearest neighbor via shared fixed-point inverse
    map). Canvas growth is symmetric, matching the padding the reference
    compensates for in rotate_bbox (alignToOCR.py:93-96)."""
    H, W = img.shape
    H2, W2 = fxp.rotated_canvas(H, W, angle_deg)
    src_y, src_x = fxp.inverse_rotation_map(H, W, H2, W2, angle_deg)
    valid = (src_y >= 0) & (src_y < H) & (src_x >= 0) & (src_x < W)
    sy = np.clip(src_y, 0, H - 1)
    sx = np.clip(src_x, 0, W - 1)
    return img[sy, sx] & valid
