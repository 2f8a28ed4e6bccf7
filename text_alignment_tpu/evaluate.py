"""Alignment-quality evaluation harness + scoring-parameter grid search.

Reference semantics: evaluate_text_alignment.py:16-198. Ground truth is
PASCAL-VOC-style XML per folio (``{fname}_gt.xml`` with
object/name/difficult/bndbox elements); predicted syl boxes are matched by
substring-compatible syllable text, best by raw intersection; scores are
bbox IoU and ink-pixel ("black area") IoU. The 729-combination scoring grid
(:181-189) is preserved; alignments for the grid reuse pipeline-stage
injection so only NW + assembly rerun per combination (the reference's
OCR-pickle trick, :159-164).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from itertools import product

import numpy as np

from .ops import oracle


def intersect(bb1, bb2):
    """Overlap area of two {'ul','lr'} boxes, or False
    (evaluate_text_alignment.py:16-31)."""
    lr1, ul1 = bb1["lr"], bb1["ul"]
    lr2, ul2 = bb2["lr"], bb2["ul"]
    dx = min(lr1[0], lr2[0]) - max(ul1[0], ul2[0])
    dy = min(lr1[1], lr2[1]) - max(ul1[1], ul2[1])
    if (dx > 0) and (dy > 0):
        return dx * dy
    return False


def IOU(bb1, bb2):
    """Bounding-box intersection over union (evaluate_text_alignment.py:34-53)."""
    lr1, ul1 = bb1["lr"], bb1["ul"]
    lr2, ul2 = bb2["lr"], bb2["ul"]
    new_ulx = max(ul1[0], ul2[0])
    new_uly = max(ul1[1], ul2[1])
    new_lrx = min(lr1[0], lr2[0])
    new_lry = min(lr1[1], lr2[1])
    area_int = (new_lrx - new_ulx) * (new_lry - new_uly)
    area_1 = (lr1[0] - ul1[0]) * (lr1[1] - ul1[1])
    area_2 = (lr2[0] - ul2[0]) * (lr2[1] - ul2[1])
    return float(area_int) / (area_1 + area_2 - area_int)


def black_area_IOU(bb1, bb2, image: np.ndarray):
    """Ink-pixel IoU over a binarized page (evaluate_text_alignment.py:56-76)."""
    lr1, ul1 = bb1["lr"], bb1["ul"]
    lr2, ul2 = bb2["lr"], bb2["ul"]
    new_ul = (max(ul1[0], ul2[0]), max(ul1[1], ul2[1]))
    new_lr = (min(lr1[0], lr2[0]), min(lr1[1], lr2[1]))

    bb1_black = oracle.black_area(oracle.subimage(image, ul1, lr1))
    bb2_black = oracle.black_area(oracle.subimage(image, ul2, lr2))
    intersect_black = oracle.black_area(oracle.subimage(image, new_ul, new_lr))

    denom = bb1_black + bb2_black - intersect_black
    if denom == 0:
        return 0.0
    return float(intersect_black) / denom


def parse_gt_xml(path: str) -> list[dict]:
    """PASCAL-VOC-ish ground truth boxes (evaluate_text_alignment.py:82-98)."""
    gt_xml = ET.parse(path)
    gt_boxes = []
    for el in list(gt_xml.getroot()):
        if not el.tag == "object":
            continue
        diff = int(el.find("difficult").text)
        name = el.find("name").text
        bb = el.find("bndbox")
        ul = (int(bb.find("xmin").text), int(bb.find("ymin").text))
        lr = (int(bb.find("xmax").text), int(bb.find("ymax").text))
        gt_boxes.append({"syl": name, "difficult": diff, "ul": ul, "lr": lr})
    return gt_boxes


def evaluate_alignment(gt_boxes, align_boxes, image: np.ndarray,
                       eval_difficult: bool = False):
    """Mean (bbox IoU, ink IoU) of predicted boxes against ground truth
    (evaluate_text_alignment.py:109-131). ``image`` is the binarized page
    (un-rotated — the reference preprocesses with correct_rotation=False)."""
    score = {}
    area_score = {}
    for box in gt_boxes:
        if box["difficult"] and not eval_difficult:
            continue
        same_syl_boxes = [
            x
            for x in align_boxes
            if x["syl"] in box["syl"] or box["syl"] in x["syl"]
        ]
        if not same_syl_boxes:
            score[box["syl"]] = 0
            area_score[box["syl"]] = 0
            continue
        ints = [intersect(box, x) for x in same_syl_boxes]
        if not any(ints):
            score[box["syl"]] = 0
            area_score[box["syl"]] = 0
            continue
        best_box = same_syl_boxes[ints.index(max(ints))]
        score[box["syl"]] = IOU(box, best_box)
        area_score[box["syl"]] = black_area_IOU(box, best_box, image)

    return (
        float(np.mean(list(score.values()))),
        float(np.mean(list(area_score.values()))),
    )


DEFAULT_GRID = (
    [5, 8, 11],
    [-4, -7, -10],
    [-2, -5, -7],
    [-2, -5, -7],
    [0, -3, -5],
    [0, -3, -5],
)


def diagnose_alignment(transcript, all_chars, gt_boxes,
                       seq_align_params=None, strict=True,
                       iou_thresh=0.25, rotate_back=None):
    """Per-syllable failure classification for an aligned page — the
    instrumented replay of the assembly walk (pipeline.assemble.
    group_syllables), answering WHERE each ground-truth syllable was
    lost: OCR (its characters aligned to gaps), alignment placement
    (boxes exist but land on the wrong line vs GT), or boundary error
    (right line, weak overlap).

    ``all_chars`` is the pipeline's post-abbreviation CharBox stream
    (process()'s all_chars return / the pik cache), ``gt_boxes`` the
    hand/synthetic GT dicts ({'syl', 'ul', 'lr'}). When the page was
    deskewed, ``all_chars`` live in the ROTATED frame while GT lives in
    the raw frame — pass ``rotate_back=(angle, rotated_shape,
    raw_shape)`` to apply the pipeline's own un-rotation
    (pipeline.assemble.rotate_bboxes) before comparing. Returns a dict:
    ``categories`` maps syllable index -> (syl, category, detail) with
    categories in {'ok', 'boundary', 'wrong-line', 'aligned-to-nothing',
    'no-gt'}, plus 'counts' and 'ocr_cer' (character error rate of the
    OCR stream measured through the same alignment)."""
    import re as _re

    from .align import perform_alignment
    from .charbox import CharBox
    from .lang.syllabify import syllabify_text

    ocr = "".join(c.char for c in all_chars)
    tra_align, ocr_align = perform_alignment(
        list(transcript), list(ocr), scoring_system=seq_align_params,
        backend="host", strict=strict)
    tra_align = "".join(tra_align)
    ocr_align = "".join(ocr_align)

    # OCR character error rate through the alignment: non-gap pairs that
    # mismatch + every gap on either side, over the transcript length
    errs = sum(1 for a, b in zip(tra_align, ocr_align)
               if a != b)
    cer = errs / max(1, len(transcript))

    chars = list(all_chars)
    for i, ch in enumerate(ocr_align):
        if ch == "_":
            chars.insert(i, CharBox("_"))
    assert len(chars) == len(tra_align)

    # GT boxes by consumption order: match each syllable occurrence to the
    # next unused GT entry with the same text (GT is emitted in reading
    # order by both the reference harness and the synthetic generator)
    gt_pool = list(gt_boxes)

    def take_gt(syl):
        for k, g in enumerate(gt_pool):
            if g["syl"] == syl:
                return gt_pool.pop(k)
        return None

    categories = {}
    counts = {"ok": 0, "boundary": 0, "wrong-line": 0,
              "aligned-to-nothing": 0, "no-gt": 0, "no-match": 0}
    offset = 0
    for si, syl in enumerate(syllabify_text(transcript)):
        if len(syl) < 1:
            continue
        syl_regex = "_*".join(_re.escape(c) for c in syl)
        m = _re.search(syl_regex, tra_align[offset:])
        if m is None:
            categories[si] = (syl, "no-match",
                              "syllable absent from aligned transcript")
            counts["no-match"] += 1
            continue
        start = m.start() + offset
        end = m.end() + offset
        offset = end
        boxes = [x for x in chars[start:end] if x.lr is not None]
        gt = take_gt(syl)
        if gt is None:
            categories[si] = (syl, "no-gt", "")
            counts["no-gt"] += 1
            continue
        if not boxes:
            n_gap = ocr_align[start:end].count("_")
            categories[si] = (syl, "aligned-to-nothing",
                              f"{n_gap}/{end - start} aligned chars are "
                              f"OCR gaps (chars lost by OCR)")
            counts["aligned-to-nothing"] += 1
            continue
        if len(set(x.uly for x in boxes)) > 1:
            lower = max(x.uly for x in boxes)
            boxes = [b for b in boxes if b.uly == lower]
        pred_cb = CharBox(
            syl,
            (min(x.ulx for x in boxes), min(x.uly for x in boxes)),
            (max(x.lrx for x in boxes), max(x.lry for x in boxes)),
        )
        if rotate_back is not None:
            from .pipeline.assemble import rotate_bboxes

            angle, rot_shape, raw_shape = rotate_back
            pred_cb = rotate_bboxes([pred_cb], -1 * angle, rot_shape,
                                    raw_shape)[0]
        pred = {"ul": pred_cb.ul, "lr": pred_cb.lr}
        gt_bb = {"ul": tuple(gt["ul"]), "lr": tuple(gt["lr"])}
        v = IOU(pred, gt_bb)
        if v >= iou_thresh:
            categories[si] = (syl, "ok", f"IoU {v:.2f}")
            counts["ok"] += 1
        else:
            gh = gt_bb["lr"][1] - gt_bb["ul"][1] + 1
            dy = abs(pred["ul"][1] - gt_bb["ul"][1])
            if dy > gh:
                categories[si] = (
                    syl, "wrong-line",
                    f"pred y {pred['ul'][1]} vs GT {gt_bb['ul'][1]}")
                counts["wrong-line"] += 1
            else:
                categories[si] = (syl, "boundary", f"IoU {v:.2f}")
                counts["boundary"] += 1
    return {"categories": categories, "counts": counts, "ocr_cer": cer}


def scoring_grid(grid=DEFAULT_GRID) -> np.ndarray:
    """The 729-combination scoring grid (evaluate_text_alignment.py:181-189)."""
    return np.array(list(product(*grid)))


# grid_align="auto" sends a fixture's 729 alignments to the device batch
# only from this many cells per pair up
_GRID_DEVICE_MIN_CELLS = 250_000


def grid_search(fixtures, shuffle=True, seed=None, backend="host",
                verbose=True, params_list=None, grid_align="auto",
                mesh=None):
    """Grid-search scoring parameters over evaluation fixtures.

    ``fixtures`` is a list of dicts with keys:
      raw_image (np array), transcript (str), gt_boxes (list),
      existing_ocr (list[CharBox] — the stage-injection stream so only
      NW + assembly rerun per combination).

    ``grid_align`` selects how the 729 alignments are computed:
    "device" batches ALL combinations per fixture into chunked vmapped
    device dispatches (SURVEY.md §7 step 7: the grid search becomes a
    vmapped batch of wavefronts — align.nw_jax.align_grid_jax; results
    bit-identical to the host loop, tests/test_nw.py and
    tests/test_aux.py); "host" keeps the per-combination host fill;
    "auto" (default) picks the device batch iff an accelerator platform
    is active AND the fixture's pair is large enough to beat 729 native
    host fills (per-fixture decision).

    Returns the log dict {params tuple: mean ink-IoU} sorted ascending, like
    the reference's __main__ (:191-198).
    """
    from .pipeline import process, to_JSON_dict
    from .pipeline.preprocess import preprocess_images, identify_text_lines

    if params_list is None:
        params_list = scoring_grid()
    params_list = np.asarray(params_list)
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(params_list)
    if grid_align == "auto":
        from .utils.platform import engine

        grid_align = engine("grid")
    if grid_align != "host":
        # device fill engages even from host-backend evaluate runs: warm
        # the persistent compile cache before its first jit (idempotent;
        # accelerator backends only)
        from .utils.compile_cache import ensure_compile_cache

        ensure_compile_cache()

    # preprocess each fixture once (correct_rotation=False for eval images,
    # matching evaluate_text_alignment.py:107), and once more for the
    # pipeline itself: only the scoring parameters change across the 729
    # combinations, so the raster stages are combination-invariant and
    # would otherwise be recomputed 729 times (measured 37 -> ~8 ms/combo)
    prepared = []
    for fx in fixtures:
        eval_img, _, _ = preprocess_images(
            fx["raw_image"], correct_rotation=False, backend=backend
        )
        if fx.get("existing_preproc_images") is None:
            fx = dict(fx)
            fx["existing_preproc_images"] = preprocess_images(
                fx["raw_image"], backend=backend,
                params=fx.get("preproc_params"),
            )
        image, eroded, _ = fx["existing_preproc_images"]
        strips, peaks, _ = identify_text_lines(
            image, eroded, backend=backend, verbose=False,
            params=fx.get("preproc_params"),
        )

        # device grid fill: ALL combinations' alignments for this fixture
        # in chunked lock-step device dispatches; the per-combination loop
        # below then injects its combo's (tra_align, ocr_align). The OCR
        # string must match what process computes internally: the
        # abbreviation-EXPANDED char stream (pipeline order, reference
        # alignToOCR.py:251-273).
        grid_aligns = None
        if grid_align in ("device", "auto"):
            from .align.api import align_grid as _align_grid
            from .pipeline.assemble import expand_abbreviations

            chars = expand_abbreviations(list(fx["existing_ocr"]))
            ocr = "".join(c.char for c in chars)
            # auto: a chant-page pair is cheap in the native host fill, so
            # the device batch only pays off once the pair is large enough
            # that 729 host fills dominate the chunked dispatches
            if grid_align == "device" or (
                len(fx["transcript"]) * len(ocr) >= _GRID_DEVICE_MIN_CELLS
            ):
                grid_aligns = _align_grid(
                    list(fx["transcript"]), list(ocr), params_list,
                    mesh=mesh,
                )
        prepared.append((fx, eval_img, (strips, peaks), grid_aligns))

    logs = {}
    for pi, p in enumerate(params_list):
        results = []
        for fx, eval_img, lines, grid_aligns in prepared:
            result = process(
                fx["raw_image"],
                fx["transcript"],
                seq_align_params=list(p),
                existing_ocr=fx["existing_ocr"],
                existing_preproc_images=fx.get("existing_preproc_images"),
                existing_lines=lines,
                preproc_params=fx.get("preproc_params"),
                verbose=False,
                backend=backend,
                existing_alignment=(
                    None if grid_aligns is None else grid_aligns[pi]
                ),
            )
            syl_boxes, _, peaks, _ = result
            json_dict = to_JSON_dict(syl_boxes, peaks)
            res = evaluate_alignment(
                fx["gt_boxes"], json_dict["syl_boxes"], eval_img
            )
            results.append(res[1])
        logs[tuple(int(v) for v in p)] = float(np.mean(results))
        if verbose:
            print(p, logs[tuple(int(v) for v in p)])

    ranked = sorted(logs.items(), key=lambda kv: kv[1])
    return logs, ranked
