"""Batched multi-folio pipeline (BASELINE.json config 3).

Stage-major scheduling instead of folio-major: all pages preprocess first
(device kernels hit one jit cache), then every line strip of every page
feeds one cross-folio recognizer batch (large batched matmuls instead of
10-line dispatches), then all alignments run as bucket-vmapped NW wavefronts
(one dispatch per size bucket), then host assembly. This replaces the
reference's process-level fan-out (`ocropus-rpred -Q 2` + Rodan job
parallelism, SURVEY.md §2 parallelism checklist) with on-device batching; on
a multi-device mesh the folio axis shards over 'data' (see parallel.train_dp
for the sharding pattern).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..align.scoring import resolve_scoring
from ..align.nw_jax import align_pairs_jax
from ..align import perform_alignment
from ..lang.syllabify import syllabify_text
from ..pipeline.preprocess import (
    preprocess_images,
    raster_stream,
    identify_text_lines,
)
from ..pipeline.assemble import (
    llocs_to_charboxes,
    expand_abbreviations,
    group_syllables,
    rotate_bboxes,
)
from ..pipeline.process import to_JSON_dict
from ..utils.timing import StageTimer


def _page_feed_enabled() -> bool:
    """Packed-page OCR feed (TEXT_ALIGNMENT_TPU_OCR_FEED=page|strips).

    The page feed uploads the bit-packed page once and cuts the strips in
    an extra per-folio device program; "strips" (the default) uploads the
    packed strip crops instead. The device-raster mode always uses the
    page feed (its page is already device-resident)."""
    import os

    return os.environ.get("TEXT_ALIGNMENT_TPU_OCR_FEED", "strips") == "page"


@dataclass
class FolioResult:
    syl_boxes: list
    peaks: list
    json_dict: dict
    # the folio's full OCR CharBox stream post-abbreviation-expansion —
    # the same value process() returns as all_chars (alignToOCR.py's
    # pickle side-channel), so batched callers can refresh --pickle-dir
    all_chars: list | None = None


class PipelinedOCRWorker:
    """Background OCR worker for the stage-major pipeline: dispatches each
    folio's strips as the raster loop enqueues them (uploads and device
    waits release the GIL) and runs the chunked combined collects off the
    critical path. Once half the folios are
    dispatched, their combined download starts on a second thread and hides
    under the raster of the remaining folios; only the second half's
    collect remains exposed after the raster loop ends.

    Protocol: construct with the folio count, call :meth:`put` once per
    folio (in order), then :meth:`rows` to join. On a raster failure call
    :meth:`abandon` (idempotent; also safe after full enqueue) so the
    worker — which loops exactly ``n`` times on the queue — terminates
    instead of leaking a blocked thread. Shared by ``process_batch`` and
    the repo benchmark so the two can never drift."""

    def __init__(self, recognizer, n: int):
        import queue
        import threading

        self._rec = recognizer
        self._n = n
        self._enqueued = 0
        self._cancelled = False
        self._q: queue.Queue = queue.Queue()
        self._out: dict = {}
        self._split = n // 2 if n >= 6 else None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            handles = []
            first_join = None
            for _ in range(self._n):
                item = self._q.get()
                if self._cancelled:
                    break
                handles.append(self._rec.dispatch_async(item))
                if self._split is not None and len(handles) == self._split:
                    first_join = self._rec.collect_async_bg(
                        handles[: self._split]
                    )
            if self._cancelled:
                # doomed batch: nobody will read rows(), so skip the
                # remaining dispatches and BOTH chunked downloads, which
                # would otherwise queue ahead of the NEXT batch's work (an
                # already-started background first-half download can't be
                # recalled and is left to drain)
                self._out["err"] = RuntimeError(
                    "OCR worker abandoned: the batch's raster failed"
                )
                return
            if first_join is not None:
                self._out["rows"] = first_join() + self._rec.collect_async(
                    handles[self._split:]
                )
            else:
                self._out["rows"] = self._rec.collect_async(handles)
        except BaseException as e:  # re-raised at rows()
            self._out["err"] = e

    def put(self, strips) -> None:
        self._q.put(strips)
        self._enqueued += 1

    def abandon(self) -> None:
        """Cancel a partially-enqueued batch: feed sentinels so the
        worker's fixed-count loop terminates, and flag it to skip the
        not-yet-dispatched folios and the result downloads (the batch is
        doomed — its rows are never read). No-op after full enqueue."""
        if self._enqueued >= self._n:
            return
        self._cancelled = True
        while self._enqueued < self._n:
            self.put([])

    def rows(self) -> list:
        self._thread.join()
        if "err" in self._out:
            raise self._out["err"]
        return self._out["rows"]


def process_batch(folios, recognizer, seq_align_params=None,
                  backend: str = "device", preproc_params=None,
                  timer: StageTimer | None = None,
                  existing_ocr: list | None = None,
                  existing_pre: list | None = None,
                  mesh=None,
                  min_align_device_cells: int | None = None,
                  raster_workers: int | None = None,
                  strict: bool = True) -> list[FolioResult | None]:
    """folios: list of (raw_image, transcript). Returns FolioResult per
    folio (None where OCR produced nothing alignable).

    ``existing_ocr`` optionally injects per-folio CharBox streams (stage
    fixture hook), skipping the recognizer. ``existing_pre`` injects
    per-folio (image, angle, strips, peaks) tuples, skipping the raster
    stage (the batched analog of process()'s existing_preproc_images).

    ``mesh`` shards the whole pipeline over a 1-D jax data mesh — the
    Rodan/Celery folio fan-out analog (reference textAlignment.py:51): the
    host raster runs on a thread pool (native calls release the GIL), the
    cross-folio OCR batch shards over 'data' via parallel.infer_dp, and the
    bucketed NW dispatches shard their pair axis. Output is byte-identical
    to the single-device run (tested). ``min_align_device_cells`` forwards
    to align_pairs_jax (0 forces every pair onto the device path)."""
    timer = timer or StageTimer(enabled=False)
    n = len(folios)
    if not strict:
        # quirk-fix mode: area-based saturated-CC filter (process() strict
        # docstring); the NW boundary fix rides the Scoring below
        from dataclasses import replace as _dc_replace

        from ..pipeline.preprocess import PreprocParams as _PP

        pp = preproc_params or _PP()
        if pp.sat_area_thresh == _PP.sat_area_thresh:
            from ..pipeline.preprocess import SAT_AREA_THRESH_AREA

            pp = _dc_replace(pp, sat_area_thresh=SAT_AREA_THRESH_AREA)
        preproc_params = _dc_replace(pp, sat_filter_area=True)

    if mesh is not None and recognizer is not None \
            and getattr(recognizer, "mesh", None) is not mesh:
        import copy

        recognizer = copy.copy(recognizer)
        recognizer.mesh = mesh

    # stage 1: preprocess + line identification (device-resident rasters).
    # When the recognizer normalizes on device, each folio's OCR is
    # DISPATCHED (async) as soon as its strips exist, so the accelerator
    # recognizes folio i while the host rasters folio i+1.
    pipelined = (
        existing_ocr is None
        and existing_pre is None
        and recognizer is not None
        and getattr(recognizer, "normalize_on_device", False)
        and getattr(recognizer, "mesh", None) is None
    )
    def _raster_one(raw_image):
        image, eroded, angle = preprocess_images(
            np.asarray(raw_image), backend=backend, params=preproc_params
        )
        strips, peaks, _ = identify_text_lines(
            image, eroded, backend=backend, params=preproc_params,
            verbose=False,
        )
        return image, angle, strips, peaks

    # device-resident raster (ops.raster_device): engages on the pipelined
    # hybrid path when an accelerator backend is live — the host keeps
    # only binarize+pack and the OCR stage cuts strips from the device
    # page inside its own fused program (no strip upload)
    use_device_raster = False
    use_page_feed = False
    if pipelined and backend == "hybrid":
        from ..ops import raster_device as _rd

        use_device_raster = _rd.enabled()
        # packed-page OCR feed: upload the bit-packed rotated page once
        # per folio (~0.5 MB) and cut the strips on device, instead of
        # packing + uploading ~2.4 MB of per-strip crops on the host
        # (TEXT_ALIGNMENT_TPU_OCR_FEED=page|strips|auto)
        use_page_feed = not use_device_raster and _page_feed_enabled()

    if existing_pre is not None:
        pre = list(existing_pre)
    elif mesh is not None or raster_workers:
        # folio-parallel raster: the native engine's ctypes calls release
        # the GIL, so a thread pool scales with host cores
        import os
        from concurrent.futures import ThreadPoolExecutor

        workers = raster_workers or min(n, max(1, (os.cpu_count() or 1)))
        with timer("preprocess"):
            with ThreadPoolExecutor(max_workers=workers) as ex:
                pre = list(ex.map(lambda f: _raster_one(f[0]), folios))
    else:
        pre = []
        ocr_worker = PipelinedOCRWorker(recognizer, n) if pipelined else None
        with timer("preprocess"):
            try:
                # raster_stream overlaps each folio's skew search (device
                # dispatch) with the next folios' host raster when an
                # accelerator is available, and runs the hybrid raster in
                # the run domain end to end; identical results otherwise.
                # In device-raster mode the page lives on the accelerator
                # and the OCR feed references it instead of host crops.
                if use_device_raster:
                    from ..pipeline.device_raster import (
                        DevicePage, raster_stream_device)

                    stream = raster_stream_device(
                        [np.asarray(f[0]) for f in folios], backend=backend,
                        params=preproc_params,
                    )
                else:
                    stream = raster_stream(
                        [np.asarray(f[0]) for f in folios], backend=backend,
                        params=preproc_params, want_packed=use_page_feed,
                    )
                for item in stream:
                    image, angle, strips, peaks = item[:4]
                    pre.append((image, angle, strips, peaks))
                    if ocr_worker is not None:
                        if use_device_raster and isinstance(image,
                                                            DevicePage):
                            from ..models.recognizer import DevicePageStrips

                            ocr_worker.put(DevicePageStrips(
                                image.page_packed,
                                [s.bbox for s in strips]))
                        elif use_page_feed:
                            from ..models.recognizer import DevicePageStrips

                            ocr_worker.put(DevicePageStrips(
                                item[4],
                                [(s.offset_y, s.offset_x, s.img.shape[0],
                                  s.img.shape[1]) for s in strips]))
                        else:
                            ocr_worker.put([s.img for s in strips])
            finally:
                # a raster failure must not strand the worker (it loops
                # exactly n times on the queue) — a long-lived serve
                # process would otherwise leak one blocked thread (plus
                # its in-flight device handles) per failed batch
                if ocr_worker is not None:
                    ocr_worker.abandon()

    # stage 2: OCR — join the pipelined worker (dispatches + chunked
    # combined downloads), or run one cross-folio batch
    if existing_ocr is not None:
        all_chars_per_folio = [list(x) for x in existing_ocr]
    elif pipelined:
        with timer("ocr"):
            rows_per_folio = ocr_worker.rows()
        all_chars_per_folio = []
        for rows, (_, _, strips, _) in zip(rows_per_folio, pre):
            chars, _ = llocs_to_charboxes(strips, rows)
            all_chars_per_folio.append(chars)
    else:
        flat_strips = []
        spans = []
        for _, _, strips, _ in pre:
            spans.append((len(flat_strips), len(flat_strips) + len(strips)))
            flat_strips.extend(strips)
        with timer("ocr"):
            rows_flat = recognizer.recognize_batch([s.img for s in flat_strips])
        all_chars_per_folio = []
        for (lo, hi), (_, _, strips, _) in zip(spans, pre):
            chars, _ = llocs_to_charboxes(strips, rows_flat[lo:hi])
            all_chars_per_folio.append(chars)

    # stage 3: abbreviations (host) + bucket-vmapped NW
    with timer("abbreviations"):
        all_chars_per_folio = [
            expand_abbreviations(ch) if ch else ch
            for ch in all_chars_per_folio
        ]

    sc = resolve_scoring(seq_align_params, strict=strict)
    pairs = []
    pair_idx = []
    for i, ((_, transcript), chars) in enumerate(zip(folios, all_chars_per_folio)):
        if not chars:
            continue
        ocr = "".join(x.char for x in chars)
        pairs.append((list(transcript), list(ocr)))
        pair_idx.append(i)

    with timer("align"):
        if backend in ("device", "hybrid"):
            aligned = align_pairs_jax(
                pairs, sc, min_device_cells=min_align_device_cells,
                mesh=mesh,
            )
            # non-integer/custom scoring falls back per pair
            aligned = [
                a
                if a is not None
                else perform_alignment(t, o, scoring_system=seq_align_params,
                                       backend="host", strict=strict)
                for a, (t, o) in zip(aligned, pairs)
            ]
        else:
            aligned = [
                perform_alignment(t, o, scoring_system=seq_align_params,
                                  backend="host", strict=strict)
                for t, o in pairs
            ]

    # stage 4: host assembly
    results: list[FolioResult | None] = [None] * n
    with timer("assemble"):
        for (i, (tra_align, ocr_align)) in zip(pair_idx, aligned):
            raw_image, transcript = folios[i]
            image, angle, strips, peaks = pre[i]
            chars = all_chars_per_folio[i]
            syls = syllabify_text(transcript)
            syl_boxes = group_syllables(
                syls, "".join(tra_align), "".join(ocr_align), chars
            )
            syl_boxes = rotate_bboxes(
                syl_boxes, -1 * angle, image.shape,
                np.asarray(raw_image).shape,
            )
            results[i] = FolioResult(
                syl_boxes, peaks, to_JSON_dict(syl_boxes, peaks,
                                               strict=strict),
                list(chars),
            )
    return results
