"""Batched line recognizer: the in-process replacement for the
``ocropus-rpred`` subprocess (reference: alignToOCR.py:128-184).

Given a list of onebit line strips, produces per-line llocs rows
``(char, x)`` with x in line-local pixels rounded to one decimal — the same
contract the reference parses out of ``_i.llocs`` files. Strips are
normalized host-side (scipy), bucketed by frame count to avoid recompile
storms (fixed power-of-two ladder), and run through the batched JAX
BiLSTM+CTC in as few device dispatches as there are occupied buckets.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .codec import Codec
from .lineest import CenterNormalizer, normalize_strip, DEFAULT_PAD
from .lineest_jax import normalize_batch_device
from .lstm_jax import BiLSTMParams, bilstm_forward_batched, params_from_np
from .ctc import translate_back_batched, llocs_positions
from .pyrnn import load_pyrnn

_MAX_REGIONS = 512
# device-path wire ships this many regions per line by default and
# escalates x4 toward _MAX_REGIONS when any line hits the cap: real lines
# rarely exceed ~100 chars, and the (B, 6 + 2R) result download scales
# with R
_WIRE_REGIONS = 128
_MIN_BUCKET = 128
_MAX_BUCKET = 8192


def _bucket_T(t: int) -> int:
    b = _MIN_BUCKET
    while b < t and b < _MAX_BUCKET:
        b *= 2
    return b


def _recognize_device_impl(params, packed_meta, t_max, target_height,
                           pad, max_regions, decode="region"):
    """Fully-fused device OCR: unpack -> normalize -> BiLSTM -> CTC decode
    in ONE dispatch. Strips cross to the device as bit-packed int32
    (32x smaller than f32 frames) and every result is packed into a single
    array so only one (small) download comes back.

    packed_meta: (B, Hp + 1, Wp // 32) int32 — rows [0, Hp) are
    little-endian strip bits (1 = ink) and the LAST row carries each
    strip's raw (h, w) in its first two lanes, so the whole dispatch is
    ONE host->device transfer (the extra row is ~1% more upload bytes).
    Returns (B, 6 + 2*max_regions) uint16 rows — the result crosses to
    the host at half the int32 width: [count_lo, count_hi, length_lo,
    length_hi, t_raw_lo, t_raw_hi, frames[max_regions],
    classes[max_regions]].
    Region frames are < t_max <= 8192 and classes index the charset, so
    both fit uint16 exactly; the three int32 header fields are split into
    lo/hi halves (reassembled by ``_unpack_wire_rows``).
    """
    hs = packed_meta[:, -1, 0]
    ws = packed_meta[:, -1, 1]
    packed_bits = packed_meta[:, :-1]
    B, Hp, Wq = packed_bits.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed_bits.astype(jnp.uint32)[..., None] >> shifts) & 1
    ink = bits.reshape(B, Hp, Wq * 32)
    # uint8 {0,1}: the onebit normalizer keeps every pre-matmul page
    # intermediate 1 byte wide (the f32 page this replaces was ~55 MB of
    # pure HBM traffic per sweep at the B=128 shape)
    grey = (jnp.uint8(1) - ink.astype(jnp.uint8))  # ink -> 0, bg -> 1
    frames, lengths, t_raws = normalize_batch_device(
        grey, hs, ws, target_height=target_height, pad=pad, t_max=t_max,
        onebit=True,  # grey comes from unpacked bits: exactly {0, 1}
    )
    outputs = bilstm_forward_batched(params, frames, lengths)
    fr, cl, cnt = translate_back_batched(outputs, lengths,
                                         max_regions=max_regions,
                                         mode=decode)
    hdr = jnp.stack([cnt, lengths, t_raws], axis=1).astype(jnp.int32)
    hdr16 = jnp.stack([hdr & 0xFFFF, (hdr >> 16) & 0xFFFF], axis=2)
    return jnp.concatenate(
        [hdr16.reshape(B, 6), fr, cl], axis=1
    ).astype(jnp.uint16)


_recognize_device = functools.partial(
    jax.jit,
    static_argnames=("t_max", "target_height", "pad", "max_regions",
                     "decode"),
)(_recognize_device_impl)


class DevicePageStrips:
    """OCR feed referencing a whole BIT-PACKED page instead of host strip
    crops: ``page_packed`` is (H, ceil(W/32)) int32 little-endian bit rows
    — a numpy array (uploaded once per folio by the dispatch; the batched
    pipeline's packed-page feed) or an already-device-resident array (the
    opt-in device-raster mode, no upload at all). ``bboxes`` are
    (uly, ulx, h, w) tuples in page coordinates. Passed to
    ``SeqRecognizer.dispatch_async`` in place of the host strip list."""

    __slots__ = ("page_packed", "bboxes")

    def __init__(self, page_packed, bboxes):
        self.page_packed = page_packed
        self.bboxes = list(bboxes)


class _ShapeProxy:
    """Stands in for a host strip array where only ``.shape`` is read
    (llocs position decode needs the raw strip width)."""

    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = shape


def _unpack_wire_rows(packed_u16: np.ndarray) -> np.ndarray:
    """uint16 wire rows -> (B, 3 + 2*max_regions) int32
    [count, length, t_raw, frames, classes] (see _recognize_device)."""
    p = np.asarray(packed_u16).astype(np.int32)
    hdr = p[:, 0:6:2] + (p[:, 1:6:2] << 16)
    return np.concatenate([hdr, p[:, 6:]], axis=1)


class SeqRecognizer:
    """BiLSTM+CTC line recognizer with ocropy-compatible input contract."""

    def __init__(self, params: BiLSTMParams, codec: Codec,
                 target_height: int = 48, pad: int = DEFAULT_PAD,
                 normalize_on_device: bool = False, mesh=None,
                 decode: str = "region"):
        """``normalize_on_device=True`` runs line normalization on the
        accelerator too (models.lineest_jax): the whole OCR stage becomes
        one dispatch + one small download per bucket. Frames match the
        scipy normalizer to ~1e-5 except at center-truncation knife edges
        (<1% of pixels, ±1 row); strict scipy-exact runs keep the host
        normalizer (the default)."""
        from ..utils.compile_cache import ensure_compile_cache

        ensure_compile_cache()  # idempotent; accelerator backends only
        self.params = params
        self.codec = codec
        self.target_height = target_height
        self.pad = pad
        self.normalize_on_device = normalize_on_device
        # "region" = exact ocropy translate_back parity (the right decode
        # for loaded reference .pyrnn checkpoints, whose long training made
        # posteriors peaky); "bestpath" = argmax-path runs, robust for
        # freshly trained models whose blank has not yet learned to clear
        # the threshold between adjacent different characters
        # "region_end" = region segmentation + peak class, position = the
        # region's LAST frame — the right-edge estimate for the llocs box
        # contract (models.ctc.region_end_np; opt-in, non-parity)
        assert decode in ("region", "bestpath", "region_end"), decode
        self.decode = decode
        # optional jax.sharding.Mesh: shard the batch over its 'data' axis
        # (parallel.infer_dp) — the multi-chip serving path
        self.mesh = mesh
        # observed frames-per-pixel-of-width ratio (zoom scale) from the
        # last collected batch: the first dispatch of a session buckets
        # frames conservatively at Wp, later dispatches size the bucket
        # from this hint (see _initial_t_max)
        self._fpp_hint: float | None = None

    @classmethod
    def from_pyrnn(cls, path: str, decode: str = "region") -> "SeqRecognizer":
        params_np, codec, target_height = load_pyrnn(path)
        return cls(params_from_np(params_np), codec, target_height,
                   decode=decode)

    def normalize(self, strip: np.ndarray):
        lnorm = CenterNormalizer(self.target_height)
        return normalize_strip(strip, lnorm, self.pad)

    def recognize_batch(self, strips) -> list[list[tuple[str, float]]]:
        """strips: list of 2-D bool (True=ink) or grey arrays.
        Returns, per strip, the llocs rows [(char, x_one_decimal), ...]."""
        if self.normalize_on_device and all(
            np.asarray(s).dtype == bool for s in strips
        ):
            # grey-valued strips keep the host normalizer (the device path
            # is defined over onebit crops, the pipeline's production input)
            return self._recognize_batch_device(strips)
        prepared = []  # (orig_index, frames, raw_width)
        results: list = [[] for _ in strips]
        for i, s in enumerate(strips):
            norm = self.normalize(np.asarray(s))
            if norm is None:
                continue  # blank line -> no llocs rows
            frames, raw_w = norm
            prepared.append((i, frames, raw_w))

        # group by bucketed frame count
        buckets: dict[int, list[int]] = {}
        for k, (_, frames, _) in enumerate(prepared):
            buckets.setdefault(_bucket_T(frames.shape[0]), []).append(k)

        for Tb, members in sorted(buckets.items()):
            # pad the batch dim to a power of two as well (blank lines decode
            # to zero regions) so repeated folios reuse one compilation
            B = max(8, 1 << (len(members) - 1).bit_length())
            xs = np.zeros((B, Tb, self.target_height), np.float32)
            lengths = np.zeros(B, np.int32)
            for bi, k in enumerate(members):
                _, frames, _ = prepared[k]
                T = frames.shape[0]
                if T > Tb:  # line longer than the ladder top: clip
                    frames = frames[:Tb]
                    T = Tb
                xs[bi, :T] = frames
                lengths[bi] = T

            outputs = bilstm_forward_batched(
                self.params, jnp.asarray(xs), jnp.asarray(lengths)
            )
            fr, cl, cnt = translate_back_batched(
                outputs, jnp.asarray(lengths), max_regions=_MAX_REGIONS,
                mode=self.decode
            )
            fr, cl, cnt = np.asarray(fr), np.asarray(cl), np.asarray(cnt)

            for bi, k in enumerate(members):
                orig_i, frames, raw_w = prepared[k]
                n = int(cnt[bi])
                line_frames = fr[bi, :n]
                line_classes = cl[bi, :n]
                xs_pos = llocs_positions(
                    line_frames, raw_w, int(lengths[bi]), self.pad
                )
                rows = [
                    (self.codec.charset[int(c)], x)
                    for c, x in zip(line_classes, xs_pos)
                ]
                results[orig_i] = rows

        return results

    def _dispatch_device(self, packed_meta, t_max,
                         max_regions=_MAX_REGIONS):
        if self.mesh is not None:
            from ..parallel.infer_dp import recognize_sharded_meta

            return _unpack_wire_rows(recognize_sharded_meta(
                self.params, packed_meta, self.mesh, t_max=t_max,
                target_height=self.target_height, pad=self.pad,
                max_regions=max_regions, decode=self.decode,
            ))
        return _unpack_wire_rows(np.asarray(_recognize_device(
            self.params, jnp.asarray(packed_meta), t_max=t_max,
            target_height=self.target_height, pad=self.pad,
            max_regions=max_regions, decode=self.decode,
        )))

    @staticmethod
    def _plan_pack(shapes):
        """(B, Hp, Wp) ladders for a batch of (h, w) strip shapes.

        Height rides a multiple-of-32 ladder, not powers of two: strip
        heights cluster at 60-100 px, and every normalize stage (kernel
        banks, gaussian matmuls, dewarp rolls) plus the bit-packed upload
        scales with Hp — 96 instead of 128 is ~25% off the whole OCR
        front end. The compile set stays bounded (a manuscript yields
        one or two height rungs). Width rides a multiple-of-256 ladder
        for the same reason (a 1.4k-wide sweep packs at 1536 instead of
        2048). Batch ladder: multiple-of-4 up to 16 (manuscript pages
        cluster at 9-12 lines; a power-of-two ladder would pad a 10-strip
        folio to 16), multiple-of-32 above. Sharded meshes re-pad to the
        data-axis size inside recognize_sharded, so divisibility is not a
        constraint here."""
        max_h = max(h for h, _ in shapes)
        Hp = max(32, -(-max_h // 32) * 32)
        max_w = max(w for _, w in shapes)
        Wp = max(256, -(-max_w // 256) * 256)
        n = len(shapes)
        if n <= 16:
            B = max(8, -(-n // 4) * 4)
        else:
            B = -(-n // 32) * 32
        return B, Hp, Wp

    def _pack_strips(self, inks):
        B, Hp, Wp = self._plan_pack([g.shape for g in inks])

        # +1 metadata row: each strip's raw (h, w) ride in the last row's
        # first two int32 lanes so the dispatch uploads ONE array (see
        # _recognize_device's contract)
        bits = np.zeros((B, Hp + 1, Wp // 8), np.uint8)
        hs = np.zeros(B, np.int32)
        ws = np.zeros(B, np.int32)
        for b, g in enumerate(inks):
            h, w = g.shape
            bits[b, :h, : (w + 7) // 8] = np.packbits(
                g, axis=1, bitorder="little"
            )
            hs[b], ws[b] = h, w
        meta = bits.view(np.int32).reshape(B, Hp + 1, Wp // 32)
        meta[:, Hp, 0] = hs
        meta[:, Hp, 1] = ws
        return meta, hs, ws, Wp

    def dispatch_async(self, strips):
        """Start device OCR for onebit ``strips`` WITHOUT blocking: returns
        an opaque handle whose device work overlaps whatever the host does
        next (e.g. the next folio's raster stage). Redeem with
        ``collect_async``. Grey strips and mesh-sharded recognizers run
        synchronously (same guards as recognize_batch) — the handle then
        carries the finished rows."""
        if isinstance(strips, DevicePageStrips):
            return self._dispatch_async_page(strips)
        if not strips:
            return ("rows", [], None)
        inks = [np.asarray(s) for s in strips]
        if self.mesh is not None or not all(g.dtype == bool for g in inks):
            return ("rows", self.recognize_batch(strips), None)
        packed_meta, hs, ws, Wp = self._pack_strips(inks)
        t_max = self._initial_t_max(Wp, ws[: len(inks)])
        out = _recognize_device(  # async jax dispatch: not materialized
            self.params, jnp.asarray(packed_meta), t_max=t_max,
            target_height=self.target_height, pad=self.pad,
            max_regions=_WIRE_REGIONS, decode=self.decode,
        )
        return (inks, out, (t_max, packed_meta, ws))

    def _dispatch_async_page(self, feed: DevicePageStrips):
        """dispatch_async for a device-resident page: ONE fused program
        cuts the strips from the page and recognizes them (no host strip
        pixels, no bit-packed upload). The handle is shaped exactly like
        dispatch_async's, with a ("page", ...) marker in place of the
        host packed_meta so escalation re-dispatch re-cuts on device."""
        if self.mesh is not None:
            raise NotImplementedError(
                "device-page OCR feeds are single-device (the mesh path "
                "keeps the host raster; see parallel.batch)")
        if not feed.bboxes:
            return ("rows", [], None)
        shapes = [(int(h), int(w)) for (_, _, h, w) in feed.bboxes]
        B, Hp, Wp = self._plan_pack(shapes)
        bb = np.zeros((B, 4), np.int32)
        bb[: len(feed.bboxes)] = np.asarray(feed.bboxes, np.int32)
        ws = np.zeros(B, np.int32)
        ws[: len(shapes)] = [w for _, w in shapes]
        t_max = self._initial_t_max(Wp, ws[: len(shapes)])
        bb_dev = jnp.asarray(bb)
        page_dev = jnp.asarray(feed.page_packed)  # upload iff host-side
        # two dispatches: the strip cut is its own tiny program and the
        # recognizer runs the SAME compiled program as the host-strips path
        from ..ops.raster_device import _jit_extract_strips

        pm_dev = _jit_extract_strips(Hp, Wp)(page_dev, bb_dev)
        out = _recognize_device(
            self.params, pm_dev, t_max=t_max,
            target_height=self.target_height, pad=self.pad,
            max_regions=_WIRE_REGIONS, decode=self.decode,
        )
        proxies = [_ShapeProxy(s) for s in shapes]
        # escalation re-dispatch reuses the device-resident packed_meta
        # (caps don't affect the cut, so no re-extraction is needed)
        return (proxies, out, (t_max, pm_dev, ws))

    def collect_async(self, handles):
        """Materialize a batch of dispatch_async handles (one combined
        device->host download) and decode to llocs rows per handle."""
        live = [h for h in handles if h[0] != "rows" and h[1] is not None]
        if live:
            # concat on device -> ONE download for all handles, then widen
            # the uint16 wire rows back to int32 on host
            cat = _unpack_wire_rows(np.asarray(
                jnp.concatenate([h[1] for h in live], axis=0)))
            splits = np.cumsum([h[1].shape[0] for h in live])[:-1]
            parts = iter(np.split(cat, splits, axis=0))
        results = []
        for handle in handles:
            if handle[0] == "rows":
                results.append(handle[1])
                continue
            inks, _, (t_max, packed_meta, ws) = handle
            packed = next(parts)
            packed = self._escalate_if_clipped(
                inks, packed, t_max, packed_meta
            )
            self._update_fpp_hint(packed, ws, len(inks))
            results.append(self._decode_packed(inks, packed))
        return results

    def collect_async_bg(self, handles):
        """Start :meth:`collect_async` on a background thread and return a
        zero-arg join callable yielding its rows. The wait for the device
        and the device->host copy release the GIL, so they overlap host
        compute — the batched pipeline collects the first folios'
        dispatches while it still rasters the rest. Thread-safety: JAX
        dispatch/transfer is thread-safe, and an escalation re-dispatch
        from this thread is ordered with the main thread's dispatches by
        the runtime; the _fpp_hint race only affects bucket sizing of later
        dispatches (output-identical either way — the escalation net pins
        decode values)."""
        import threading

        out: dict = {}

        def _run():
            try:
                out["rows"] = self.collect_async(handles)
            except BaseException as e:  # re-raised at join
                out["err"] = e

        th = threading.Thread(target=_run, daemon=True)
        th.start()

        def _join():
            th.join()
            if "err" in out:
                raise out["err"]
            return out["rows"]

        return _join

    def _initial_t_max(self, Wp: int, ws=None) -> int:
        """First-dispatch frame bucket. The zoom scale 48 / 2r depends on
        each strip's ink-band spread r, which only the device normalizer
        measures — a fixed guess either wastes BiLSTM steps (too big) or
        forces a second dispatch on every batch (too small; a Wp // 2
        guess did exactly that on 70 px ink bands, where the scale is
        0.7-1.4). So: the FIRST batch of a session dispatches
        conservatively at Wp, every collect records the observed
        frames-per-width-pixel ratio (_fpp_hint), and later batches size
        their bucket from the hint rounded up to a multiple-of-128 ladder
        (bounded compile set; LSTM scan steps + CTC decode + frame memory
        all scale with the bucket, and a doubling ladder wasted up to 2x
        on near-miss fits — a 523-frame sweep used to pay for 1024). The
        clip escalation below remains the correctness net when a batch's
        ink is thinner than the hint predicted. Cap at _MAX_BUCKET like
        the host bucket ladder (frames clip); beyond it the uint16 wire
        could not carry frame values anyway."""
        if self._fpp_hint is not None and ws is not None and len(ws):
            need = int(float(np.max(ws)) * self._fpp_hint) + 2 * self.pad + 2
            t = -(-need // _MIN_BUCKET) * _MIN_BUCKET
        else:
            t = Wp
        return min(_MAX_BUCKET, max(_MIN_BUCKET, t))

    def _escalate_if_clipped(self, inks, packed, t_max, packed_meta):
        """Thin-ink lines zoom to MORE frames than the strip is wide
        (scale = 48/2r > 1); if any line hit the frame cap, escalate the
        bucket and rerun so the device path matches the host normalizer's
        un-clipped output (host cap: _MAX_BUCKET). Likewise a line whose
        decode filled the wire's region block (count == R) escalates the
        region cap toward _MAX_REGIONS so no region is dropped.
        packed_meta is independent of both caps, so no re-packing."""
        R = (packed.shape[1] - 3) // 2
        n = len(inks)
        while True:
            t_clip = t_max < _MAX_BUCKET and np.any(
                packed[:n, 2] >= t_max - 2 * self.pad
            )
            r_clip = R < _MAX_REGIONS and np.any(packed[:n, 0] >= R)
            if not (t_clip or r_clip):
                return packed
            if t_clip:
                t_max = min(_MAX_BUCKET, t_max * 2)
            if r_clip:
                R = min(_MAX_REGIONS, R * 4)
            packed = self._dispatch_device(packed_meta, t_max,
                                           max_regions=R)

    def _update_fpp_hint(self, packed, ws, n):
        """Record the observed zoom ratio max(t_raw / w) of a finished
        (post-escalation) batch; sizes the next batch's first dispatch."""
        t_raw = packed[:n, 2].astype(np.float64)
        w = np.asarray(ws[:n], np.float64)
        ok = (w > 0) & (t_raw > 2 * self.pad)
        if np.any(ok):
            self._fpp_hint = float(np.max(t_raw[ok] / w[ok]))

    def _decode_packed(self, inks, packed):
        R = (packed.shape[1] - 3) // 2
        results: list = [[] for _ in inks]
        for i in range(len(inks)):
            cnt, length = int(packed[i, 0]), int(packed[i, 1])
            if cnt <= 0 or length <= 2 * self.pad:
                continue
            fr = packed[i, 3 : 3 + cnt]
            cl = packed[i, 3 + R : 3 + R + cnt]
            xs_pos = llocs_positions(fr, inks[i].shape[1], length, self.pad)
            results[i] = [
                (self.codec.charset[int(c)], x) for c, x in zip(cl, xs_pos)
            ]
        return results

    def _recognize_batch_device(self, strips):
        """Device-normalized path: onebit strips are bit-packed into one
        (B, Hp, Wp/32) int32 upload per bucket; everything else happens on
        device.

        One dispatch per sweep: chunk-shaped programs would multiply the
        compile set and the escalation re-dispatches. Folio-grain overlap
        is the batched pipeline's job (dispatch_async per folio)."""
        if not strips:
            return []
        inks = [np.asarray(s) for s in strips]
        packed_meta, hs, ws, Wp = self._pack_strips(inks)
        t_max = self._initial_t_max(Wp, ws[: len(inks)])
        packed = self._dispatch_device(packed_meta, t_max,
                                       max_regions=_WIRE_REGIONS)
        packed = self._escalate_if_clipped(
            inks, packed, t_max, packed_meta
        )
        self._update_fpp_hint(packed, ws, len(inks))
        return self._decode_packed(inks, packed)
