"""End-to-end page alignment: the framework's `process()`.

Public contract mirrors the reference (alignToOCR.py:187-351): given a text
layer image and a transcript string, returns
``(syl_boxes, image, lines_peak_locs, all_chars)`` and ``to_JSON_dict``
serializes the canonical output (including the reference's
75th-percentile-as-"median" line spacing quirk, alignToOCR.py:338).

Differences by design (accelerator architecture, same behavior):
- OCR runs in-process through the batched JAX BiLSTM+CTC recognizer instead
  of an ocropus-rpred subprocess + llocs tempfiles; ``wkdir_name`` and
  ``parallel`` are accepted for signature compatibility and ignored.
- ``backend`` selects host-oracle vs device kernels for raster + NW stages.
- ``existing_ocr_pickle`` keeps the reference's stage-memoization behavior
  (alignToOCR.py:225-233); ``existing_ocr`` injects the char stream
  directly (the generalized fixture-injection hook, SURVEY.md §4.4).
"""

from __future__ import annotations

import pickle

import numpy as np

from ..charbox import CharBox
from ..align import perform_alignment
from ..lang.syllabify import syllabify_text
from ..utils.timing import stage_timer
from .preprocess import preprocess_images, identify_text_lines
from .assemble import (
    llocs_to_charboxes,
    expand_abbreviations,
    group_syllables,
    rotate_bboxes,
)

MEDIAN_LINE_MULT = 2  # threaded but unused, as in the reference (alignToOCR.py:25,193)


# stage routing by platform, read WITHOUT forcing backend initialization
# on pure-host code paths
from ..utils.platform import engine


def _resolve_recognizer(ocropus_model, backend="host"):
    if ocropus_model is None:
        return None
    if isinstance(ocropus_model, str):
        from ..models.recognizer import SeqRecognizer

        rec = SeqRecognizer.from_pyrnn(ocropus_model)
        # accelerator schedules normalize lines on device too (one fused
        # dispatch per OCR bucket); host/parity runs — and hybrid on a
        # CPU-only runtime — keep scipy lineest
        rec.normalize_on_device = (
            backend in ("device", "hybrid")
            and engine("ocr_normalize") == "device"
        )
        return rec
    return ocropus_model  # already a SeqRecognizer


def _model_cache_id(ocropus_model) -> str:
    """Cache identity for the OCR model: path + mtime + size for files,
    a weight-content hash for in-memory recognizers."""
    import os

    if isinstance(ocropus_model, str):
        try:
            st = os.stat(ocropus_model)
            return f"{ocropus_model}:{st.st_mtime_ns}:{st.st_size}"
        except OSError:
            return ocropus_model
    params = getattr(ocropus_model, "params", None)
    if params is not None:
        from ..utils.cache import content_key

        leaves = [np.asarray(x) for x in _tree_leaves(params)]
        charset = getattr(getattr(ocropus_model, "codec", None),
                          "charset", ())
        cfg = (
            tuple(charset),
            getattr(ocropus_model, "target_height", None),
            getattr(ocropus_model, "pad", None),
            getattr(ocropus_model, "normalize_on_device", None),
            getattr(ocropus_model, "decode", "region"),
        )
        return content_key("model", repr(cfg), *leaves)
    return repr(type(ocropus_model))


def _tree_leaves(params):
    import jax

    return jax.tree_util.tree_leaves(params)


def process(raw_image, transcript, ocropus_model=None, seq_align_params=None,
            wkdir_name=None, parallel=None, median_line_mult=MEDIAN_LINE_MULT,
            existing_ocr_pickle=None, existing_preproc_images=None,
            verbose=True, backend="host", existing_ocr=None, timer=None,
            preproc_params=None, stage_cache=None, existing_lines=None,
            existing_alignment=None, strict=True):
    """Align ``transcript`` to the text-layer ``raw_image``.

    raw_image: (H, W[, C]) uint8/bool numpy array (or anything np.asarray
    accepts). Returns (syl_boxes, image, lines_peak_locs, all_chars_copy) or
    None when OCR fails/produces nothing alignable.

    ``stage_cache``: a utils.cache.StageCache (or directory path) that
    memoizes the preprocess and OCR stages under content-derived keys —
    the first-class version of the reference's filename-keyed pickles
    (alignToOCR.py:207-215, :225-233).

    ``strict=False`` fixes the documented reference defects instead of
    preserving them (SURVEY.md §7 "reference defects"): the stage-1
    saturated-CC filter measures true pixel area (not row count), and the
    NW boundary rows extend at the scoring system's own gap extends (not
    the stale module global -1). Pair with ``to_JSON_dict(...,
    strict=False)`` for the true-median line spacing. ``median_line_mult``
    is accepted-and-inert in BOTH modes: the reference threads it into
    process() but never uses it (alignToOCR.py:25,193), and no intended
    semantics are recoverable to "fix".
    """
    del wkdir_name, parallel  # subprocess-era knobs
    raw_image = np.asarray(raw_image)
    timer = timer or stage_timer(enabled=False)
    if not strict:
        from dataclasses import replace
        from .preprocess import PreprocParams

        pp = preproc_params or PreprocParams()
        if pp.sat_area_thresh == PreprocParams.sat_area_thresh:
            # parity default 150 was tuned for the nrows quirk; the area
            # filter gets its own corrected default (see preprocess.py)
            from .preprocess import SAT_AREA_THRESH_AREA

            pp = replace(pp, sat_area_thresh=SAT_AREA_THRESH_AREA)
        preproc_params = replace(pp, sat_filter_area=True)

    if isinstance(stage_cache, str):
        from ..utils.cache import StageCache

        stage_cache = StageCache(stage_cache)

    # -- PRE-PROCESSING --
    # existing_preproc_images revives the reference's (commented-out)
    # preproc memoization hook (alignToOCR.py:207-215): a tuple
    # (image_bin, image_eroded, angle) skips the raster stage.
    if existing_preproc_images is not None:
        image, eroded, angle = existing_preproc_images
    else:
        with timer("preprocess"):
            def _run_preproc():
                return preprocess_images(
                    raw_image, backend=backend, params=preproc_params
                )

            if stage_cache is not None:
                from ..utils.cache import content_key

                image, eroded, angle = stage_cache.cached(
                    "preproc",
                    content_key("preproc", raw_image, repr(preproc_params)),
                    _run_preproc,
                )
            else:
                image, eroded, angle = _run_preproc()
    # existing_lines: (strips, peak_locations) — the line-segmentation
    # analog of existing_preproc_images, for callers that sweep a
    # raster-invariant parameter (the evaluation grid search reruns only
    # NW + assembly per scoring combination)
    if existing_lines is not None:
        cc_strips, lines_peak_locs = existing_lines
    else:
        with timer("identify_lines"):
            cc_strips, lines_peak_locs, _ = identify_text_lines(
                image, eroded, backend=backend, verbose=verbose,
                params=preproc_params,
            )

    # -- OCR --
    all_chars = []
    if existing_ocr is not None:
        all_chars = list(existing_ocr)
    elif existing_ocr_pickle:
        from ..utils.ref_pickle import load_charboxes

        try:
            with open(existing_ocr_pickle, "rb") as f:
                all_chars = load_charboxes(f)
            if verbose:
                print("using pickled ocr results in {}...".format(existing_ocr_pickle))
        except IOError:
            if verbose:
                print(
                    "Pickle file {} not found - performing ocr instead".format(
                        existing_ocr_pickle
                    )
                )
        except AttributeError:
            if verbose:
                print("Pickle error: re-performing ocr")

    if not all_chars and existing_ocr is None:
        # an explicitly injected EMPTY stream is a valid OCR result (the
        # skip-folio path below, reference alignToOCR.py:241-243), not a
        # missing source
        if ocropus_model is None:
            raise ValueError(
                "no OCR source: pass ocropus_model, existing_ocr, or a "
                "readable existing_ocr_pickle"
            )
        with timer("ocr"):
            def _run_ocr():
                # resolved lazily: a cache hit never pays the model load
                recognizer = _resolve_recognizer(ocropus_model, backend)
                rows = recognizer.recognize_batch(
                    [s.img for s in cc_strips]
                )
                return llocs_to_charboxes(cc_strips, rows)

            if stage_cache is not None:
                from ..utils.cache import content_key

                # key covers everything that determines the OCR output:
                # the strips (derived from image+eroded+params), the model
                # weights (content/mtime identity), and the normalization
                # path (backend + platform decide scipy vs device lineest,
                # which differ at truncation knife edges)
                all_chars, _other = stage_cache.cached(
                    "ocr",
                    content_key(
                        "ocr", image, eroded, repr(preproc_params),
                        _model_cache_id(ocropus_model),
                        backend, engine("ocr_normalize"),
                    ),
                    _run_ocr,
                )
            else:
                all_chars, _other = _run_ocr()

    if not all_chars:
        if verbose:
            print("OCR produced no characters! Skipping current file.")
        return None

    # -- ABBREVIATIONS --
    with timer("abbreviations"):
        all_chars = expand_abbreviations(all_chars)

    ocr = "".join(x.char for x in all_chars)
    all_chars_copy = list(all_chars)

    # -- ALIGNMENT + ASSEMBLY --
    # existing_alignment: a precomputed (tra_align, ocr_align) pair — the
    # NW-stage analog of the other existing_* hooks, for callers that
    # batch MANY alignments of one char stream in a single device dispatch
    # (the 729-combination grid search via align.nw_jax.align_grid_jax).
    # It MUST have been computed from this exact transcript and the
    # abbreviation-expanded OCR stream; group_syllables' length assert
    # (reference alignToOCR.py:291-292) still guards the contract.
    if existing_alignment is not None:
        tra_align, ocr_align = existing_alignment
    else:
        with timer("align"):
            # hybrid routes by platform and pair size: only pairs past the
            # cells threshold (align.api.auto_device_min_cells) go to the
            # device wavefront. Results are bit-identical either way
            # (tested).
            nw_backend = {
                "host": "host", "device": "jax",
            }.get(backend) or engine("nw")
            tra_align, ocr_align = perform_alignment(
                list(transcript), list(ocr), scoring_system=seq_align_params,
                verbose=False, backend=nw_backend, strict=strict,
            )
    tra_align = "".join(tra_align)
    ocr_align = "".join(ocr_align)

    with timer("assemble"):
        syls = syllabify_text(transcript)
        syl_boxes = group_syllables(syls, tra_align, ocr_align, all_chars)
        syl_boxes = rotate_bboxes(
            syl_boxes, -1 * angle, image.shape, raw_image.shape
        )

    return syl_boxes, image, lines_peak_locs, all_chars_copy


def to_JSON_dict(syl_boxes, lines_peak_locs, strict=True) -> dict:
    """Canonical output dict (alignToOCR.py:333-351). NB
    'median_line_spacing' is the 75th percentile of inter-peak gaps — a
    reference quirk preserved for downstream MEI-encoding compatibility
    (``strict=False`` uses the true median the field name promises).
    Pages with fewer than two detected lines have no inter-peak gaps; the
    spacing degrades to 0.0 instead of crashing (the reference would
    IndexError on np.quantile of an empty diff)."""
    if len(lines_peak_locs) < 2:
        med_line_spacing = 0.0
    else:
        med_line_spacing = np.quantile(np.diff(lines_peak_locs),
                                       0.75 if strict else 0.5)

    data = {}
    data["median_line_spacing"] = med_line_spacing
    data["syl_boxes"] = []

    for s in syl_boxes:
        data["syl_boxes"].append(
            {
                "syl": s.char,
                "ul": [int(s.ul[0]), int(s.ul[1])],
                "lr": [int(s.lr[0]), int(s.lr[1])],
            }
        )

    return data
