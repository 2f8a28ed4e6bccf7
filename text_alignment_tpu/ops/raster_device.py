"""Fully-fused device raster: the page never comes back to the host.

The host raster stage is the batched pipeline's biggest host item; the
all-XLA ``backend="device"`` path is compile-pathological because its CC
labeling is a data-dependent pixel-domain while_loop. This module rebuilds
the raster as static-shape device programs around the run-graph CC kernel
(:mod:`.cc_runs`) so the whole stage leaves the host:

- **Program A** (``raster_page``): bit-packed binarized page in (the host
  keeps only greyscale+Otsu+binarize+packbits) →
  despeckle → white-despeckle → tall-CC removal → the three-round skew
  decision-tree search (:mod:`.skew_device`, fused — no pack/unpack round
  trip) → rotation about the center into a **fixed worst-case canvas**
  with the content at origin (the per-leaf exact canvas (H2, W2) and Q16
  coefficients ride in as 4693-leaf constant tables, so the one program
  covers every reachable angle without dynamic shapes) → erode (k=2 run
  filters) → row projection. Downloads: the projection vector, the three
  winner indices, and an ``ok`` flag — a few KB.
- **Program B** (``masked_cc_table``): separator rows (host peak logic)
  erased on the device-resident eroded page → run-graph CC stats →
  compact noise-filtered table. Download: the (max_ccs, 5) table.
- **Program C** (``extract_strips_packed``): line-strip crops cut from
  the device-resident binarized page straight into the recognizer's
  bit-packed ``(B, Hp+1, Wp//32)`` wire tensor (models/recognizer.py
  ``_pack_strips`` layout, byte-for-byte), so the OCR stage starts from
  device memory — the per-folio strip upload disappears entirely.

Every stage is bit-exact against the host oracle (the rotated max-canvas
page equals the exact-canvas page padded with white; run filters, row
projections and CC stats are padding-invariant). The ``ok`` flag from the
CC kernel (convergence certificate + run-table overflow) gates a host
fallback per page — never silently wrong.

Reference semantics: textAlignPreprocessing.py:160-285 (preprocess_images
+ identify_text_lines); rotation padding contract alignToOCR.py:93-96.
"""

from __future__ import annotations

import functools

import numpy as np

from . import fixedpoint as fxp
from . import cc_runs

_A23 = 19  # rounds 2/3 grid size (skew_device recipe)


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------

def pack_page(img) -> np.ndarray:
    """Host: bool/0-1 uint8 (H, W) page -> (H, ceil(W/32)) int32
    little-endian bit rows (np.packbits bitorder='little' + int32 view)."""
    img = np.asarray(img)
    H, W = img.shape
    Wq = -(-W // 32)
    bits = np.zeros((H, Wq * 4), np.uint8)
    bits[:, : (W + 7) // 8] = np.packbits(
        img.astype(bool), axis=1, bitorder="little")
    return bits.view(np.int32)


@functools.lru_cache(maxsize=None)
def leaf_tables(H: int, W: int, minangle: float = -6.0,
                maxangle: float = 6.0):
    """Per-leaf rotation constants for every angle reachable by the
    coarse-to-fine recipe: (cfix, sfix, H2, W2) int32 arrays of length
    A1*19*19, flat-indexed by (i1*19 + i2)*19 + i3, plus the worst-case
    canvas (H2max, W2max). All trig in float64 on host (fxp contract)."""
    c1 = fxp.angle_grid(minangle, maxangle, 1.0)
    angles = []
    for b1 in c1:
        for b2 in fxp.angle_grid(b1 - 0.9, b1 + 0.9, 0.1):
            angles.extend(fxp.angle_grid(b2 - 0.09, b2 + 0.09, 0.01))
    cf = np.empty(len(angles), np.int32)
    sf = np.empty(len(angles), np.int32)
    h2 = np.empty(len(angles), np.int32)
    w2 = np.empty(len(angles), np.int32)
    for i, a in enumerate(angles):
        cf[i], sf[i] = fxp.rotation_coeffs(a)
        h2[i], w2[i] = fxp.rotated_canvas(H, W, a)
    return (cf, sf, h2, w2), (int(h2.max()), int(w2.max()))


def exact_canvas(H: int, W: int, angle: float) -> tuple[int, int]:
    """The exact rotated-canvas shape for a detected angle — what the
    host-raster path's ``image_bin.shape`` would be (rotate_bboxes needs
    it; the device page lives on the max canvas with content at origin)."""
    return fxp.rotated_canvas(H, W, angle)


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def _unpack_bits(packed, W: int):
    import jax.numpy as jnp

    H, Wq = packed.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed.astype(jnp.uint32)[..., None] >> shifts) & 1
    return bits.reshape(H, Wq * 32)[:, :W] != 0


def _rotate_max_canvas(img, cfix, sfix, H2, W2, H2max: int, W2max: int):
    """Nearest-neighbor rotation via the shared Q16 inverse map
    (fxp.inverse_rotation_map formula with runtime scalars), rendered into
    the fixed (H2max, W2max) canvas with the exact-canvas content at the
    origin and white beyond it."""
    import jax.numpy as jnp

    H, W = img.shape
    x2 = jnp.arange(W2max, dtype=jnp.int32)[None, :]
    y2 = jnp.arange(H2max, dtype=jnp.int32)[:, None]
    dx2 = 2 * x2 - (W2 - 1)
    dy2 = 2 * y2 - (H2 - 1)
    sx2 = cfix * dx2 + sfix * dy2
    sy2 = -sfix * dx2 + cfix * dy2
    src_x = (sx2 + (W - 1) * fxp.SCALE + fxp.SCALE) >> (fxp.SCALE_BITS + 1)
    src_y = (sy2 + (H - 1) * fxp.SCALE + fxp.SCALE) >> (fxp.SCALE_BITS + 1)
    valid = (
        (src_y >= 0) & (src_y < H) & (src_x >= 0) & (src_x < W)
        & (y2 < H2) & (x2 < W2)
    )
    sy = jnp.clip(src_y, 0, H - 1)
    sx = jnp.clip(src_x, 0, W - 1)
    return img.reshape(-1)[(sy * W + sx).reshape(-1)].reshape(
        H2max, W2max) & valid


@functools.lru_cache(maxsize=None)
def _make_raster_page(H: int, W: int, minangle: float, maxangle: float,
                      max_runs: int, sat_by_area: bool = False):
    """Program A builder for one page geometry. The returned function maps
    (packed (H, ceil(W/32)) int32, despeckle_amt, sat_area_thresh) ->
    (bin_rot (H2max, W2max) bool, eroded (H2max, W2max) bool,
     proj (H2max,) int32, idx (3,) int32, ok () bool)."""
    import jax.numpy as jnp

    from . import skew_device as sd
    from .device import filter_runs_impl

    (cf, sf, h2, w2), (H2max, W2max) = leaf_tables(H, W, minangle, maxangle)
    cfj, sfj = jnp.asarray(cf), jnp.asarray(sf)
    h2j, w2j = jnp.asarray(h2), jnp.asarray(w2)
    Hp = -(-H // 16) * 16
    Wp = -(-W // 128) * 128
    search = sd._make_search(Hp, Wp, minangle, maxangle)

    def fn(packed, despeckle_amt, sat_area_thresh):
        img = _unpack_bits(packed, W)
        img, ok = cc_runs.preproc_clean(
            img, despeckle_amt, sat_area_thresh, max_runs,
            sat_by_area=sat_by_area)
        imgb = jnp.pad(
            img.astype(jnp.float32), ((0, Hp - H), (0, Wp - W))
        ).reshape(Hp, Wp // 128, 128)
        idx = search(imgb, jnp.int32(H), jnp.int32(W))
        leaf = (idx[0] * _A23 + idx[1]) * _A23 + idx[2]
        bin_rot = _rotate_max_canvas(
            img, cfj[leaf], sfj[leaf], h2j[leaf], w2j[leaf], H2max, W2max)
        eroded = filter_runs_impl(bin_rot, 2, "black", 0)
        eroded = filter_runs_impl(eroded, 2, "black", 1)
        proj = jnp.sum(eroded, axis=1, dtype=jnp.int32)
        return bin_rot, eroded, proj, idx, ok

    return fn, (H2max, W2max)


def _masked_cc_table_impl(eroded, row_mask, noise_thresh, max_ccs: int,
                          max_runs: int):
    """Program B: separator-erased CC table of the eroded page
    (textAlignPreprocessing.py:217-235 semantics; the noise filter
    ``area > noise_thresh`` runs on device so the download shrinks)."""
    er = eroded & ~row_mask[:, None]
    return cc_runs.cc_table_compact(
        er, min_area_keep=noise_thresh, max_ccs=max_ccs, max_runs=max_runs)


def _extract_strips_packed_impl(page_packed, bbox, Hp: int, Wp: int):
    """Program C: cut (B,) line strips from a bit-packed page into the
    recognizer's wire tensor — dynamic-slice + shift-combine only, no
    random-index gathers.

    page_packed: (Hpage, ceil(Wpage/32)) int32 little-endian bit rows
    (ops.device.pack_bool / host pack_page layout). bbox: (B, 4) int32
    rows (uly, ulx, h, w); zero-area rows produce blank strips. Output:
    (B, Hp + 1, Wp // 32) int32 — byte-identical to models/recognizer.py
    ``_pack_strips`` on the same crops (last row carries (h, w) in lanes
    0, 1)."""
    import jax
    import jax.numpy as jnp

    B = bbox.shape[0]
    Wqs = Wp // 32
    # pad so no dynamic_slice ever clamps (a clamped start would shift
    # which page rows land in the window)
    pg = jnp.pad(page_packed, ((0, Hp), (0, Wqs + 1)))
    u = jax.lax.bitcast_convert_type(pg, jnp.uint32)
    outs = []
    for b in range(B):  # static unroll over the batch ladder
        uly = jnp.maximum(bbox[b, 0], 0)
        ulx = jnp.maximum(bbox[b, 1], 0)
        s = (ulx & 31).astype(jnp.uint32)
        win = jax.lax.dynamic_slice(
            u, (uly, ulx >> 5), (Hp, Wqs + 1))
        lo = win[:, :Wqs] >> s
        hi = jnp.where(s == 0, jnp.uint32(0),
                       win[:, 1:] << ((jnp.uint32(32) - s) & 31))
        outs.append(lo | hi)
    strips = jnp.stack(outs)  # (B, Hp, Wqs) uint32
    hs, ws = bbox[:, 2], bbox[:, 3]
    row_ok = jnp.arange(Hp, dtype=jnp.int32)[None, :] < hs[:, None]
    kword = jnp.arange(Wqs, dtype=jnp.int32)[None, :]
    keep = jnp.clip(ws[:, None] - 32 * kword, 0, 32).astype(jnp.uint32)
    mask = jnp.where(keep >= 32, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << (keep & 31)) - 1)
    strips = jnp.where(row_ok[:, :, None], strips & mask[:, None, :],
                       jnp.uint32(0))
    packed = jax.lax.bitcast_convert_type(strips, jnp.int32)
    meta = jnp.zeros((B, 1, Wqs), jnp.int32)
    meta = meta.at[:, 0, 0].set(hs).at[:, 0, 1].set(ws)
    return jnp.concatenate([packed, meta], axis=1)


@functools.lru_cache(maxsize=None)
def _jit_raster_page_wire(H: int, W: int, minangle: float, maxangle: float,
                          max_runs: int, sat_by_area: bool = False):
    """Program A with its small outputs packed into ONE int32 wire vector
    ``[proj (H2max) | i1 i2 i3 | ok]`` so grouped pulls ship one array
    per group."""
    import jax
    import jax.numpy as jnp

    fn, (H2max, W2max) = _make_raster_page(H, W, minangle, maxangle,
                                           max_runs, sat_by_area)

    def wire_fn(packed, despeckle_amt, sat_area_thresh):
        bin_rot, eroded, proj, idx, ok = fn(
            packed, despeckle_amt, sat_area_thresh)
        wire = jnp.concatenate(
            [proj, idx, ok.astype(jnp.int32)[None]])
        return bin_rot, eroded, wire

    return jax.jit(wire_fn), (H2max, W2max)


@functools.lru_cache(maxsize=None)
def _jit_masked_cc_wire(max_ccs: int, max_runs: int):
    """Program B with wire output ``[count | ok | table.flat]``
    ((2 + max_ccs*5,) int32)."""
    import jax
    import jax.numpy as jnp

    def wire_fn(eroded, row_mask, noise_thresh):
        table, count, ok = _masked_cc_table_impl(
            eroded, row_mask, noise_thresh, max_ccs=max_ccs,
            max_runs=max_runs)
        return jnp.concatenate(
            [count[None], ok.astype(jnp.int32)[None], table.reshape(-1)])

    return jax.jit(wire_fn)


@functools.lru_cache(maxsize=None)
def _jit_masked_cc_table(max_ccs: int, max_runs: int):
    import jax

    return jax.jit(functools.partial(
        _masked_cc_table_impl, max_ccs=max_ccs, max_runs=max_runs))


@functools.lru_cache(maxsize=None)
def _jit_extract_strips(Hp: int, Wp: int):
    import jax

    return jax.jit(functools.partial(
        _extract_strips_packed_impl, Hp=Hp, Wp=Wp))


@functools.lru_cache(maxsize=None)
def _jit_raster_page(H: int, W: int, minangle: float, maxangle: float,
                     max_runs: int, sat_by_area: bool = False):
    import jax

    fn, canvas = _make_raster_page(H, W, minangle, maxangle, max_runs,
                                   sat_by_area)
    return jax.jit(fn), canvas


def enabled() -> bool:
    """Whether the batched pipeline should run the raster on the device
    (TEXT_ALIGNMENT_TPU_RASTER=device|host; default host).

    Opt-in: the path is bit-exact with certificates and compile-tractable,
    but its run-graph CC is built from gathers and scatters, and the
    native host union-find is the production raster. The mode is the
    correctness-tested path for hosts with no native toolchain."""
    import os

    return os.environ.get("TEXT_ALIGNMENT_TPU_RASTER", "host") == "device"


class GroupedPull:
    """Grouped device->host downloads for same-length int32 wire vectors.

    Each per-array pull pays a latency floor; this worker stacks
    ``group`` vectors into one device array (one tiny dispatch) and a
    collector thread downloads the stack off the caller's thread — the
    same amortization pattern as
    skew_device.GroupedSkewWorker. Protocol: ``put(vec)`` returns a slot,
    ``get(slot)`` blocks for that vector's row, ``finish()`` flushes
    partial groups (idempotent; call on abandon so the collector always
    exits)."""

    def __init__(self, group: int = 4):
        import queue
        import threading

        self._group = group
        self._bufs: dict = {}   # length -> [vec list, slot list]
        self._n = 0
        self._out: dict = {}
        self._cv = threading.Condition()
        self._q: queue.Queue = queue.Queue()
        self._finished = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            slots, stacked = item
            try:
                rows = np.asarray(stacked)
                res = list(rows[: len(slots)])
            except BaseException as e:  # re-raised at get()
                res = [e] * len(slots)
            with self._cv:
                for s, r in zip(slots, res):
                    self._out[s] = r
                self._cv.notify_all()

    def put(self, vec) -> int:
        key = int(vec.shape[0])
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = [[], []]
        vecs, slots = buf
        slot = self._n
        self._n += 1
        vecs.append(vec)
        slots.append(slot)
        if len(slots) == self._group:
            self._flush(key)
        return slot

    def _flush(self, key):
        import jax.numpy as jnp

        vecs, slots = self._bufs.pop(key)
        self._q.put((list(slots), jnp.stack(vecs)))

    def get(self, slot: int) -> np.ndarray:
        for key, (_vecs, slots) in list(self._bufs.items()):
            if slot in slots:
                self._flush(key)
                break
        with self._cv:
            while slot not in self._out:
                self._cv.wait()
            r = self._out.pop(slot)
        if isinstance(r, BaseException):
            raise r
        return r

    def finish(self):
        if self._finished:
            return
        self._finished = True
        try:
            for key in list(self._bufs):
                self._flush(key)
        finally:
            self._q.put(None)


# ---------------------------------------------------------------------------
# synchronous single-page wrappers (tests / sequential callers)
# ---------------------------------------------------------------------------

def raster_page(bin_img, despeckle_amt: int, sat_area_thresh: int,
                minangle: float = -6.0, maxangle: float = 6.0,
                max_runs: int = cc_runs.MAX_RUNS, sat_by_area: bool = False):
    """Run program A for one host binarized page. Returns
    (bin_rot_dev, eroded_dev, proj np, angle float, ok bool, (H2, W2)).
    The two page tensors stay on device (feed programs B / C)."""
    import jax.numpy as jnp

    from . import skew_device as sd

    bin_img = np.asarray(bin_img)
    H, W = bin_img.shape
    fn, _canvas = _jit_raster_page(H, W, minangle, maxangle, max_runs,
                                   sat_by_area)
    bin_rot, eroded, proj, idx, ok = fn(
        jnp.asarray(pack_page(bin_img)), jnp.int32(despeckle_amt),
        jnp.int32(sat_area_thresh))
    i1, i2, i3 = np.asarray(idx).tolist()
    angle = sd.angle_from_indices(i1, i2, i3, minangle, maxangle)
    return (bin_rot, eroded, np.asarray(proj), angle, bool(np.asarray(ok)),
            exact_canvas(H, W, angle))


def masked_cc_table(eroded_dev, sep_rows, H2: int, noise_thresh: int,
                    max_ccs: int = 4096, max_runs: int = cc_runs.MAX_RUNS):
    """Run program B: separator-masked noise-filtered CC table. sep_rows
    are the host's separator row indices (2-px each); H2 bounds the mask
    build. Returns (table np (count, 5) int64, ok)."""
    import jax.numpy as jnp

    H2max = int(eroded_dev.shape[0])
    mask = np.zeros(H2max, bool)
    for idx in sep_rows:
        mask[idx: idx + 2] = True
    fn = _jit_masked_cc_table(max_ccs, max_runs)
    table, count, ok = fn(eroded_dev, jnp.asarray(mask),
                          jnp.int32(noise_thresh))
    count = int(np.asarray(count))
    return (np.asarray(table)[:count].astype(np.int64),
            bool(np.asarray(ok)))


def extract_strips_packed(page_packed_dev, bboxes, Hp: int, Wp: int):
    """Run program C: (uly, ulx, h, w) rows -> recognizer packed_meta
    (device array). ``page_packed_dev``: (H, ceil(W/32)) int32 bit rows
    (device.pack_bool / pack_page layout)."""
    import jax.numpy as jnp

    fn = _jit_extract_strips(Hp, Wp)
    return fn(page_packed_dev, jnp.asarray(np.asarray(bboxes, np.int32)))
