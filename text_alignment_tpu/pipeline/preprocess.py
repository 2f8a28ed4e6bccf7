"""Page preprocessing and text-line segmentation.

Reference semantics: textAlignPreprocessing.py:160-285 (`preprocess_images`,
`identify_text_lines`), re-expressed over the framework's raster engines.
All engines produce identical pixels/strips:

- ``backend="host"``  — numpy oracle ops (the CPU baseline path);
- ``backend="hybrid"``— the native C++ raster engine (:mod:`..ops.
  host_native`, union-find CC / run filters) with numpy for the rest; the
  production default for the raster stage. Connected-component labeling is
  branch-heavy integer chasing — a union-find in C++ runs the whole page
  in milliseconds, while the equivalent pixel-domain XLA program at page
  shape is a compile-time pathology. The FLOP-heavy stages (recognizer,
  NW) still run on the device; see ``process()``.
- ``backend="device"``— JAX kernels from :mod:`..ops.device`; page
  tensors stay on device across the fused op sequence, with only the
  projection vector, histogram, and compact CC table coming back to host.

Projection smoothing, peak prominence, and all per-CC list logic are
host-side float64/python on *all* paths (they are O(H) / O(#CCs)), so every
data-dependent decision (peaks, separators, strip bboxes) is bit-identical
across backends by construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import oracle
from ..ops.projections import (
    moving_avg_filter,
    find_peak_locations,
    FILTER_SIZE,
)

# PARAMETERS (reference: textAlignPreprocessing.py:12-26; the unused
# saturation_thresh / cc_group_gap_min / max_distance_to_staff are dropped)
SAT_AREA_THRESH = 150       # CCs taller than this many rows are removed
# strict=False corrected-mode default: the reference's comment promises an
# AREA filter but 150 px of area would remove every glyph (area >= nrows
# always). The corrected default targets the same artifacts the row filter
# was tuned for — blobs as tall AND wide as its 150-row target.
SAT_AREA_THRESH_AREA = 150 * 150
DESPECKLE_AMT = 100
NOISE_AREA_THRESH = 100
COLLISION_STRIP_SCALE = 1
REMOVE_CAPITALS_SCALE = 10000


@dataclass
class PreprocParams:
    sat_area_thresh: int = SAT_AREA_THRESH
    despeckle_amt: int = DESPECKLE_AMT
    noise_area_thresh: int = NOISE_AREA_THRESH
    filter_size: int = FILTER_SIZE
    collision_strip_scale: float = COLLISION_STRIP_SCALE
    remove_capitals_scale: float = REMOVE_CAPITALS_SCALE
    # strict=False corrected mode: filter the stage-1 "saturated" CCs by
    # true pixel area instead of the reference's nrows-as-area quirk
    # (textAlignPreprocessing.py:174-178). NB the default threshold (150)
    # was tuned for the nrows semantics — area mode usually wants a much
    # larger sat_area_thresh.
    sat_filter_area: bool = False


@dataclass
class LineStrip:
    """A text-line crop of the binarized page. Coordinate contract matches
    the Gamera subimages the reference passes to OCR (alignToOCR.py:160-162):
    ``height`` is nrows - 1, so offset_y + height = the strip's last row."""

    img: np.ndarray  # bool (nrows, ncols)
    offset_x: int
    offset_y: int

    @property
    def height(self) -> int:
        return self.img.shape[0] - 1

    @property
    def width(self) -> int:
        return self.img.shape[1] - 1


def _raster_engine(backend: str):
    """Host raster op namespace for the given backend: the native C++
    engine for ``hybrid`` (falling back to the oracle when no toolchain is
    present), the pure-numpy oracle otherwise."""
    if backend == "hybrid":
        from ..ops import host_native

        if host_native.available():
            return host_native
    return oracle


def vertically_coincide(hline_position, comp_offset, comp_nrows, collision,
                        collision_scale=COLLISION_STRIP_SCALE):
    """True if any part of the component lies within the strip around the
    line position (textAlignPreprocessing.py:38-56)."""
    collision *= collision_scale
    component_top = comp_offset
    component_bottom = comp_offset + comp_nrows
    strip_top = hline_position - int(collision / 2)
    strip_bottom = hline_position + int(collision / 2)
    both_above = component_top < strip_top and component_bottom < strip_top
    both_below = component_top > strip_bottom and component_bottom > strip_bottom
    return not both_above and not both_below


def preprocess_images(input_image, despeckle_amt: int = DESPECKLE_AMT,
                      filter_runs: int = 1, filter_runs_amt: int = 2,
                      correct_rotation: bool = True, backend: str = "host",
                      params: PreprocParams | None = None):
    """Binarize + denoise + deskew (textAlignPreprocessing.py:160-195).

    Returns (image_bin, image_eroded, angle) as numpy bool arrays.
    """
    p = params or PreprocParams()
    input_image = np.asarray(input_image)

    if backend == "device":
        from ..ops import device as eng
        from ..ops import fixedpoint as fxp
        import jax.numpy as jnp

        # stage 0: greyscale + histogram on device; Otsu criterion on host
        grey = eng.to_greyscale(jnp.asarray(input_image))
        hist = np.asarray(eng.grey_histogram(grey))
        thresh = eng._otsu_from_hist(hist)

        # stage 1: binarize + despeckle x2 + tall/big-CC removal
        img = eng.preproc_stage1(
            grey,
            jnp.uint8(thresh),
            jnp.int32(despeckle_amt),
            jnp.int32(p.sat_area_thresh),
            sat_by_area=p.sat_filter_area,
        )

        angle = eng.rotation_angle_projections(img, -6, 6)

        if correct_rotation:
            H, W = int(img.shape[0]), int(img.shape[1])
            H2, W2 = fxp.rotated_canvas(H, W, angle)
            cfix, sfix = fxp.rotation_coeffs(angle)
            packed_bin, packed_eroded, _proj = eng.rotate_erode_project(
                img, jnp.int32(cfix), jnp.int32(sfix), H2, W2,
                filter_runs, filter_runs_amt,
            )
            W_out = W2
        else:
            packed_bin, packed_eroded, _proj = eng.rotate_erode_project(
                img, jnp.int32(fxp.SCALE), jnp.int32(0),
                int(img.shape[0]), int(img.shape[1]),
                filter_runs, filter_runs_amt,
            )
            W_out = int(img.shape[1])

        image_bin = eng.unpack_bool(np.asarray(packed_bin), W_out)
        image_eroded = eng.unpack_bool(np.asarray(packed_eroded), W_out)
        return image_bin, image_eroded, angle

    eng = _raster_engine(backend)
    if hasattr(eng, "preprocess_page"):
        # native engine: the whole raster chain stays on uint8 buffers
        return eng.preprocess_page(input_image, despeckle_amt,
                                   p.sat_area_thresh, filter_runs,
                                   filter_runs_amt, correct_rotation,
                                   sat_area=p.sat_filter_area)
    img = eng.to_onebit(input_image)
    img = eng.despeckle(img, despeckle_amt)
    img = ~eng.despeckle(~img, despeckle_amt)
    if p.sat_filter_area:
        img = oracle.remove_big_ccs(img, p.sat_area_thresh)
    else:
        img = eng.remove_tall_ccs(img, p.sat_area_thresh)
    angle = eng.rotation_angle_projections(img, -6, 6)
    if correct_rotation:
        img = eng.rotate_onebit(img, angle)
    eroded = img.copy()
    for _ in range(filter_runs):
        eroded = eng.filter_short_runs(eroded, filter_runs_amt, "black")
        eroded = eng.filter_narrow_runs(eroded, filter_runs_amt, "black")
    return img, eroded, angle


def preprocess_stream(images, backend: str = "host",
                      despeckle_amt: int = DESPECKLE_AMT,
                      filter_runs: int = 1, filter_runs_amt: int = 2,
                      correct_rotation: bool = True,
                      params: PreprocParams | None = None,
                      skew: str = "auto", depth: int = 8):
    """Yield ``preprocess_images(...)`` results for a stream of pages,
    overlapping each page's skew search with the next pages' host raster
    when an accelerator is available.

    On the hybrid backend with the native engine and a live accelerator
    (``skew="auto"``; force with "device"/"host"), each page runs as:
    native stage 1 (host) -> :mod:`..ops.skew_device` search (ONE async
    accelerator dispatch, ~1.4 ms of host pack+upload instead of ~6 ms of
    host shear rounds) -> native rotate+erode (host). Up to ``depth``
    skew searches stay in flight, so the accelerator latency hides under
    the following folios' host work — which is why this is a *stream* API:
    the sequential ``preprocess_images`` path would expose the full
    dispatch round trip per page. Results are bit-identical to
    ``preprocess_images`` on every path (the device search replays the
    same Q16 grids and exact integer criterion; tested).
    """
    images = list(images)
    use_device_skew = False
    if backend == "hybrid" and correct_rotation and len(images) > 1:
        from ..ops import host_native, skew_device

        if skew == "device" or (skew == "auto" and skew_device.enabled()):
            use_device_skew = host_native.available()
    if not use_device_skew:
        for raw in images:
            yield preprocess_images(
                raw, despeckle_amt=despeckle_amt, filter_runs=filter_runs,
                filter_runs_amt=filter_runs_amt,
                correct_rotation=correct_rotation, backend=backend,
                params=params,
            )
        return

    from collections import deque

    from ..ops import host_native as hn
    from ..ops.skew_device import GroupedSkewWorker

    p = params or PreprocParams()
    pend: deque = deque()
    n = len(images)
    worker = GroupedSkewWorker()

    def _enqueue(i):
        img, runs, n_runs = hn.preprocess_page_phase1(
            np.asarray(images[i]), despeckle_amt, p.sat_area_thresh,
            sat_area=p.sat_filter_area,
        )
        pend.append((img, runs, n_runs, worker.put(img)))

    try:
        # lookahead window: a page's angle is only dispatched at its
        # group boundary and then rides one grouped pull (~25 ms), so the
        # window must span ~2 groups of host raster for the pull to hide
        for i in range(min(depth, n)):
            _enqueue(i)
        nxt = min(depth, n)
        if nxt == n:
            worker.finish()
        while pend:
            if nxt < n:  # keep the accelerator fed before blocking
                _enqueue(nxt)
                nxt += 1
                if nxt == n:
                    worker.finish()
            img, runs, n_runs, slot = pend.popleft()
            angle = worker.angle(slot)
            image_bin, image_eroded = hn.preprocess_page_phase2(
                img, runs, n_runs, angle, filter_runs, filter_runs_amt,
                correct_rotation,
            )
            yield image_bin, image_eroded, angle
    finally:
        # abandoned mid-stream (caller error, generator close): flush so
        # the collector thread always terminates instead of leaking
        worker.finish()


def raster_stream(images, backend: str = "host",
                  despeckle_amt: int = DESPECKLE_AMT,
                  params: PreprocParams | None = None,
                  skew: str = "auto", depth: int = 8,
                  want_packed: bool = False):
    """Yield the whole per-folio raster — ``(image_bin, angle, strips,
    peaks)`` — for a stream of pages: the batched pipeline's stage-1 loop
    (parallel/batch.py).

    On the hybrid backend with the native engine, the page lives in the
    RUN domain end to end: stage 1 exports runs, the skew upload packs
    bits straight from them (no page re-read), rotation emits rotated
    runs alongside the pixel page, the erode + row projection + separator
    -masked CC stats all run on runs — the eroded pixel page is never
    materialized, saving ~3 full-page passes on the one-core host. The
    device skew search engages exactly as in :func:`preprocess_stream`.
    Results are bit-identical to preprocess_images + identify_text_lines
    on every path (tested). ``want_packed=True`` appends a fifth element
    per folio: the rotated binarized page as (H2, ceil(W2/32)) int32
    little-endian bit rows (the packed-page OCR feed's upload; packed
    from the rotated run list on the native path, np.packbits
    otherwise)."""
    images = list(images)
    p = params or PreprocParams()
    fused = False
    if backend == "hybrid":
        from ..ops import host_native as hn

        fused = hn.available()
    if not fused:
        stream = preprocess_stream(images, backend=backend,
                                   despeckle_amt=despeckle_amt, params=p,
                                   skew=skew, depth=depth)
        for image_bin, image_eroded, angle in stream:
            strips, peaks, _ = identify_text_lines(
                image_bin, image_eroded, backend=backend, params=p,
                verbose=False)
            if want_packed:
                yield image_bin, angle, strips, peaks, _pack_page_np(
                    image_bin)
            else:
                yield image_bin, angle, strips, peaks
        return

    from ..ops import host_native as hn
    from ..ops import skew_device

    use_device_skew = len(images) > 1 and (
        skew == "device" or (skew == "auto" and skew_device.enabled()))

    def _finish(img, runs, n_runs, angle):
        out = hn.preprocess_page_phase2_runs(
            img, runs, n_runs, angle, correct_rotation=True,
            want_packed=want_packed)
        image_bin, eruns, en, proj = out[:4]
        strips, peaks, _ = identify_text_lines_runs(
            image_bin, eruns, en, proj, params=p, verbose=False)
        if want_packed:
            return image_bin, float(angle), strips, peaks, out[4]
        return image_bin, float(angle), strips, peaks

    if not use_device_skew:
        for raw in images:
            img, runs, n_runs = hn.preprocess_page_phase1(
                np.asarray(raw), despeckle_amt, p.sat_area_thresh,
                sat_area=p.sat_filter_area)
            angle = hn.rotation_angle_projections(
                img, -6, 6, runs_n=(runs, n_runs))
            yield _finish(img, runs, n_runs, angle)
        return

    from collections import deque

    from ..ops.skew_device import GroupedSkewWorker

    pend: deque = deque()
    n = len(images)
    worker = GroupedSkewWorker()

    def _enqueue(i):
        img, runs, n_runs = hn.preprocess_page_phase1(
            np.asarray(images[i]), despeckle_amt, p.sat_area_thresh,
            sat_area=p.sat_filter_area)
        slot = worker.put_runs(runs, n_runs, img.shape[0], img.shape[1])
        pend.append((img, runs, n_runs, slot))

    try:
        # same 2-group lookahead window as preprocess_stream
        for i in range(min(depth, n)):
            _enqueue(i)
        nxt = min(depth, n)
        if nxt == n:
            worker.finish()
        while pend:
            if nxt < n:  # keep the accelerator fed before blocking
                _enqueue(nxt)
                nxt += 1
                if nxt == n:
                    worker.finish()
            img, runs, n_runs, slot = pend.popleft()
            angle = worker.angle(slot)
            yield _finish(img, runs, n_runs, angle)
    finally:
        worker.finish()


def _cc_table(img, backend):
    """(uly, lry, ulx, lrx, area) int rows for every CC, scan order."""
    if backend == "device":
        from ..ops import device as eng

        table, count = eng.cc_stats_compact(img)
        table = np.asarray(table)
        count = int(count)
        if count > table.shape[0]:
            raise RuntimeError(
                f"page has {count} CCs > MAX_CCS={table.shape[0]}"
            )
        return table[:count].astype(np.int64)
    eng = _raster_engine(backend)
    if eng is not oracle:
        return eng.cc_stats(np.asarray(img))
    _, table = oracle.cc_stats(np.asarray(img))
    return table


def identify_text_lines(image_bin, image_eroded, backend: str = "host",
                        params: PreprocParams | None = None, verbose: bool = False):
    """Find text lines (textAlignPreprocessing.py:198-285).

    Returns (line_strips, peak_locations, smoothed_projection).
    """
    p = params or PreprocParams()

    if backend == "device":
        from ..ops import device as eng
        import jax.numpy as jnp

        eroded_dev = jnp.asarray(np.asarray(image_eroded))
        project = np.asarray(eng.projection_rows(eroded_dev))
    else:
        project = _raster_engine(backend).projection_rows(
            np.asarray(image_eroded)
        )

    def table_fn(sep_rows):
        return _sep_masked_cc_table(image_eroded, sep_rows, backend)

    return _lines_from_projection(image_bin, project, table_fn, p, verbose)


def identify_text_lines_runs(image_bin, eroded_runs, n_eruns, proj,
                             params: PreprocParams | None = None,
                             verbose: bool = False):
    """identify_text_lines over a run-encoded eroded page (native engine's
    fused phase-2 output, host_native.preprocess_page_phase2_runs): the
    row projection arrives precomputed and the separator-masked CC stats
    come straight off the run list, so the eroded pixel page never exists.
    Bit-identical results (tested)."""
    from ..ops import host_native as hn

    p = params or PreprocParams()
    H = len(proj)

    def table_fn(sep_rows):
        mask = np.zeros(H, dtype=bool)
        for idx in sep_rows:
            mask[idx : idx + 2] = True
        return hn.cc_stats_from_runs(eroded_runs, n_eruns, H, mask)

    return _lines_from_projection(image_bin, proj, table_fn, p, verbose)


def _sep_masked_cc_table(image_eroded, sep_rows, backend):
    """CC table of the eroded page with 2-px separator rows erased
    (textAlignPreprocessing.py:217-235), per backend."""
    if backend == "device":
        import jax.numpy as jnp
        from ..ops import device as eng

        H = int(image_eroded.shape[0])
        mask = np.zeros(H, dtype=bool)
        for idx in sep_rows:
            mask[idx : idx + 2] = True
        table_dev, count = eng.erase_and_ccstats(
            jnp.asarray(np.asarray(image_eroded)), jnp.asarray(mask)
        )
        count = int(count)
        table = np.asarray(table_dev)
        if count > table.shape[0]:
            raise RuntimeError(f"page has {count} CCs > MAX_CCS={table.shape[0]}")
        return table[:count].astype(np.int64)
    eng = _raster_engine(backend)
    if hasattr(eng, "cc_stats_masked"):
        # native path: masked rows are treated as white during run
        # extraction — no page copy at all
        H = int(np.asarray(image_eroded).shape[0])
        mask = np.zeros(H, dtype=bool)
        for idx in sep_rows:
            mask[idx : idx + 2] = True
        return eng.cc_stats_masked(np.asarray(image_eroded), mask)
    # one copy, then in-place separator erasure (draw_hline_white
    # copies the whole page per call — 10 lines would be 10 copies)
    eroded_cut = np.array(image_eroded, copy=True)
    for idx in sep_rows:
        eroded_cut[idx : idx + 2, :] = False
    return _cc_table(eroded_cut, backend)


def _peaks_and_separators(project, p: PreprocParams):
    """Peaks of the smoothed row projection + the 2-px separator rows at
    inter-peak minima (textAlignPreprocessing.py:211-224)."""
    smoothed_projection = moving_avg_filter(project, p.filter_size)
    peak_locations = find_peak_locations(smoothed_projection)
    sep_rows = []
    for i in range(len(peak_locations) - 1):
        start = peak_locations[i]
        end = peak_locations[i + 1]
        idx = int(np.argmin(smoothed_projection[start:end])) + start
        sep_rows.append(idx)
    return peak_locations, sep_rows, smoothed_projection


def _strip_bboxes_from_table(table, peak_locations, p: PreprocParams):
    """CC filtering + per-peak collision strips -> inclusive strip bboxes
    [(ulx, uly, lrx, lry)] (textAlignPreprocessing.py:229-257).

    Drops small CCs (strictly greater than the threshold survives —
    textAlignPreprocessing.py:235), then the (inert) capitals filter.
    Vectorized over the CC table; the arithmetic (incl. the truncating
    int() of the half-strip in vertically_coincide) matches the scalar
    reference logic value for value."""
    t = np.asarray(table).reshape(-1, 5)
    t = t[t[:, 4] > p.noise_area_thresh]
    if len(t) == 0:
        return []

    nrows_v = t[:, 1] - t[:, 0] + 1
    med_comp_height = np.median(nrows_v)
    keep = nrows_v < med_comp_height * p.remove_capitals_scale
    t = t[keep]
    nrows_v = nrows_v[keep]

    cc_median_height = np.median(nrows_v)
    # vertically_coincide's half-strip: int(collision/2) truncates toward 0
    half = int((cc_median_height * p.collision_strip_scale) / 2)

    comp_top = t[:, 0]
    comp_bottom = t[:, 0] + nrows_v
    bboxes = []
    for line_loc in peak_locations:
        strip_top = line_loc - half
        strip_bottom = line_loc + half
        both_above = (comp_top < strip_top) & (comp_bottom < strip_top)
        both_below = (comp_top > strip_bottom) & (comp_bottom > strip_bottom)
        res = t[~both_above & ~both_below]
        if len(res) == 0:
            # the reference would crash on min() of an empty list
            # (textAlignPreprocessing.py:251); we skip the empty line
            continue
        bboxes.append((int(res[:, 2].min()), int(res[:, 0].min()),
                       int(res[:, 3].max()), int(res[:, 1].max())))
    return bboxes


def _lines_from_projection(image_bin, project, table_fn, p: PreprocParams,
                           verbose: bool = False):
    """Shared tail of identify_text_lines: peaks from the (eroded-page)
    row projection, separator rows at inter-peak minima, then the CC
    filtering + per-peak collision strips (textAlignPreprocessing.py:
    198-285). ``table_fn(sep_rows)`` supplies the separator-masked CC
    table — pixel- or run-domain."""
    if verbose:
        print("finding projection peaks...")
    peak_locations, sep_rows, smoothed_projection = _peaks_and_separators(
        project, p)

    if verbose:
        print("connected component analysis...")

    table = table_fn(sep_rows)
    image_bin_np = np.asarray(image_bin)
    line_strips = []
    for ulx, uly, lrx, lry in _strip_bboxes_from_table(
            table, peak_locations, p):
        strip = oracle.subimage(image_bin_np, (ulx, uly), (lrx, lry))
        line_strips.append(LineStrip(strip, ulx, uly))

    return line_strips, peak_locations, smoothed_projection


def _pack_page_np(image_bin) -> np.ndarray:
    """(H, W) bool -> (H, ceil(W/32)) int32 little-endian bit rows (the
    numpy fallback for the packed-page OCR feed)."""
    a = np.asarray(image_bin)
    H, W = a.shape
    bits = np.zeros((H, -(-W // 32) * 4), np.uint8)
    bits[:, : (W + 7) // 8] = np.packbits(a, axis=1, bitorder="little")
    return bits.view(np.int32)
