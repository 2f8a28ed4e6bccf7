"""Device-resident batched raster stream (ops.raster_device wiring).

The host raster is the stage-major batched pipeline's biggest host item.
In this mode the host keeps only greyscale + Otsu + binarize + packbits
and everything else — the
despeckle/CC cleanup, the skew search, rotation, erosion, projection, the
separator-masked CC stats and the line-strip cutting — happens on the
accelerator against a device-resident page:

    host: binarize+pack ──upload──▶ program A (clean+skew+rotate+erode+
    project; grouped wire pull: projection + winner indices + ok)
    host: peaks/separators ──mask──▶ program B (masked CC table; grouped
    wire pull) ──▶ host: strip bboxes ──▶ the OCR stage cuts strips from
    the device page inside its own fused program (models/recognizer
    DevicePageStrips feed) — the per-folio strip upload disappears.

Pages flow through in order with a lookahead window, so the device works
on folios i+1.. while the host waits on folio i's grouped pulls.
Bit-exactness: every device stage is pinned against the host oracle
(tests/test_raster_device.py); pages whose CC kernel reports
non-convergence or run overflow fall back to the host raster path —
never silently wrong. Reference semantics: textAlignPreprocessing.py:
160-285."""

from __future__ import annotations

from collections import deque

import numpy as np

from ..ops import oracle
from ..ops import raster_device as rd
from .preprocess import (
    PreprocParams,
    DESPECKLE_AMT,
    preprocess_images,
    identify_text_lines,
    _peaks_and_separators,
    _strip_bboxes_from_table,
)

_MAX_CCS = 2048  # post-noise-filter glyph CCs per page (overflow -> host)


class DevicePage:
    """Stands in for the rotated binarized page in device-raster mode:
    ``shape`` is the EXACT rotated canvas (what the host raster would
    produce — rotate_bboxes consumes it), while ``page_packed`` is the
    device-resident bit-packed page on the fixed worst-case canvas with
    content at origin (the recognizer's packed-page feed layout)."""

    __slots__ = ("page_packed", "shape")

    def __init__(self, page_packed, shape):
        self.page_packed = page_packed
        self.shape = shape


class StripRef:
    """LineStrip metadata without pixels (the crop stays on device).
    Coordinate contract matches LineStrip: height = nrows - 1."""

    __slots__ = ("offset_x", "offset_y", "h", "w")

    def __init__(self, ulx, uly, lrx, lry):
        self.offset_x = ulx
        self.offset_y = uly
        self.h = lry - uly + 1
        self.w = lrx - ulx + 1

    @property
    def height(self):
        return self.h - 1

    @property
    def width(self):
        return self.w - 1

    @property
    def bbox(self):
        """(uly, ulx, h, w) row for the device strip cutter."""
        return (self.offset_y, self.offset_x, self.h, self.w)


def _binarize_pack(raw_image):
    """Host front end: greyscale + Otsu + binarize + packbits (native
    fused grey/hist when available)."""
    raw = np.asarray(raw_image)
    try:
        from ..ops import host_native as hn

        if hn.available() and raw.ndim == 3:
            grey, hist = hn._greyscale_hist(raw)
        else:
            grey = oracle.to_greyscale(raw)
            hist = np.bincount(grey.reshape(-1), minlength=256)
    except Exception:
        grey = oracle.to_greyscale(raw)
        hist = np.bincount(grey.reshape(-1), minlength=256)
    thresh = oracle.otsu_from_hist(hist)
    return rd.pack_page(grey <= thresh), grey.shape


def raster_stream_device(images, backend: str = "hybrid",
                         despeckle_amt: int = DESPECKLE_AMT,
                         params: PreprocParams | None = None,
                         depth: int = 8, group: int = 4):
    """Yield per-folio ``(image, angle, strips, peaks)`` with the raster
    on the accelerator. ``image`` is a :class:`DevicePage` and ``strips``
    are :class:`StripRef` rows for device-rastered folios; fallback
    folios (CC certificate failed) yield the host types."""
    import jax.numpy as jnp

    from ..ops import skew_device as sd

    images = list(images)
    p = params or PreprocParams()
    n = len(images)
    ga = rd.GroupedPull(group)
    gb = rd.GroupedPull(group)
    pend_a: deque = deque()
    pend_b: deque = deque()
    results: dict = {}

    def _host_fallback(i):
        image, eroded, angle = preprocess_images(
            np.asarray(images[i]), despeckle_amt=despeckle_amt,
            backend=backend if backend != "device" else "hybrid",
            params=p)
        strips, peaks, _ = identify_text_lines(
            image, eroded, backend="hybrid", params=p, verbose=False)
        return image, angle, strips, peaks

    def start_a(i):
        packed, (H, W) = _binarize_pack(images[i])
        fn, _canvas = rd._jit_raster_page_wire(H, W, -6.0, 6.0,
                                               rd.cc_runs.MAX_RUNS,
                                               p.sat_filter_area)
        bin_dev, er_dev, wire = fn(
            jnp.asarray(packed), jnp.int32(despeckle_amt),
            jnp.int32(p.sat_area_thresh))
        pend_a.append((i, bin_dev, er_dev, ga.put(wire), (H, W)))

    def advance_a():
        i, bin_dev, er_dev, slot, (H, W) = pend_a.popleft()
        wire = ga.get(slot)
        if not wire[-1]:
            results[i] = _host_fallback(i)
            return
        i1, i2, i3 = wire[-4:-1].tolist()
        angle = sd.angle_from_indices(i1, i2, i3)
        H2, W2 = rd.exact_canvas(H, W, angle)
        proj = wire[:-4][:H2].astype(np.int64)
        peaks, sep_rows, _sm = _peaks_and_separators(proj, p)
        H2max = int(er_dev.shape[0])
        mask = np.zeros(H2max, bool)
        for r in sep_rows:
            mask[r: r + 2] = True
        fnb = rd._jit_masked_cc_wire(_MAX_CCS, rd.cc_runs.MAX_RUNS)
        wire_b = fnb(er_dev, jnp.asarray(mask),
                     jnp.int32(p.noise_area_thresh))
        pend_b.append((i, bin_dev, angle, (H2, W2), peaks, gb.put(wire_b)))

    def advance_b():
        from ..ops.device import pack_bool

        i, bin_dev, angle, shape, peaks, slot = pend_b.popleft()
        w = gb.get(slot)
        count, okb = int(w[0]), bool(w[1])
        if not okb:
            results[i] = _host_fallback(i)
            return
        table = w[2:].reshape(_MAX_CCS, 5)[:count].astype(np.int64)
        strips = [StripRef(*bb)
                  for bb in _strip_bboxes_from_table(table, peaks, p)]
        results[i] = (DevicePage(pack_bool(bin_dev), shape), angle,
                      strips, peaks)

    out = 0
    next_a = 0
    try:
        while out < n:
            while next_a < n and next_a - out < depth:
                start_a(next_a)
                next_a += 1
            if out in results:
                yield results.pop(out)
                out += 1
            elif pend_b and pend_b[0][0] == out:
                advance_b()
            elif pend_a and pend_a[0][0] == out:
                # pull a whole group of A results forward so the B
                # dispatches (and their grouped pull) batch together
                for _ in range(min(group, len(pend_a))):
                    advance_a()
            else:  # pragma: no cover - invariant
                raise AssertionError("folio lost in device raster stream")
    finally:
        ga.finish()
        gb.finish()
