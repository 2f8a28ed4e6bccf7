"""Real-asset parity harness: point the framework at a reference checkout
and get a parity report.

The bit-identical-JSON guarantee is proven in-tree against the numpy
oracle and synthetic folios; the reference's actual pages/models are
stripped from this environment (/root/reference/.MISSING_LARGE_BLOBS).
This module packages the day-one workflow for when real assets exist:

    python -m text_alignment_tpu verify-reference --assets /path/to/checkout

discovers the reference checkout's layout (alignToOCR.py:378-438 —
``png/{manuscript}_{fname}_text.png``, ``csv/`` chant CSVs + optional
``mapping.csv``, ``pik/{fname}_boxes.pickle`` OCR caches,
``models/*.pyrnn.gz``, ``out_json/{fname}.json`` outputs,
``ground-truth-alignments/{fname}_gt.xml``), runs every discovered folio
end-to-end, and reports:

- a structural diff of our ``syl_boxes`` JSON vs the reference's
  ``out_json`` output when present (syllable text + boxes exact,
  median_line_spacing numeric);
- bbox IoU / ink IoU vs the hand-labeled GT XML when present
  (evaluate_text_alignment.py:79-175 metrics);
- the OCR source per folio (reference ``pik`` cache = NW+assembly parity;
  ``.pyrnn.gz`` model = full-stack parity including the recognizer).

Exit status: 0 when every folio with a reference JSON matches exactly.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

# manuscript -> (chant-CSV filename hint, needs mapping.csv, model hint)
# (reference alignToOCR.py:387-405 manuscript blocks)
_MANUSCRIPTS = {
    "salzinnes": ("salzinnes", True, "salzinnes"),
    "einsiedeln": ("einsiedeln", False, "salzinnes"),
    "stgall390": ("stgall390", False, "stgall"),
    "stmaurf": ("stmaurf", False, "stgall"),
}


@dataclass
class FolioReport:
    fname: str
    manuscript: str
    ocr_source: str = "model"
    status: str = "ran"           # ran | match | MISMATCH | error | skipped
    detail: str = ""
    n_syls: int | None = None
    ref_n_syls: int | None = None
    bbox_iou: float | None = None
    ink_iou: float | None = None


@dataclass
class Report:
    folios: list = field(default_factory=list)
    n_match: int = 0
    n_mismatch: int = 0
    n_no_reference: int = 0
    n_error: int = 0

    def to_dict(self):
        return {
            "summary": {
                "match": self.n_match,
                "mismatch": self.n_mismatch,
                "no_reference": self.n_no_reference,
                "error": self.n_error,
            },
            "folios": [vars(f) for f in self.folios],
        }


def _find_csvs(assets):
    csv_dir = os.path.join(assets, "csv")
    if not os.path.isdir(csv_dir):
        return {}, None
    names = os.listdir(csv_dir)
    mapping = next(
        (os.path.join(csv_dir, n) for n in names
         if n.lower() == "mapping.csv"), None)
    csvs = {}
    for n in names:
        if n.lower() == "mapping.csv" or not n.lower().endswith(".csv"):
            continue
        for man, (hint, _needs_map, _model) in _MANUSCRIPTS.items():
            if hint in n.lower():
                csvs[man] = os.path.join(csv_dir, n)
    return csvs, mapping


def _find_model(assets, hint):
    for d in ("models", "."):
        mdir = os.path.join(assets, d)
        if not os.path.isdir(mdir):
            continue
        cands = sorted(n for n in os.listdir(mdir)
                       if n.endswith(".pyrnn.gz"))
        for n in cands:
            if hint in n.lower():
                return os.path.join(mdir, n)
        if len(cands) == 1:
            return os.path.join(mdir, cands[0])
    return None


def discover(assets: str):
    """Map the checkout: returns (pages, csvs, mapping) where pages is a
    list of (manuscript, fname, png_path)."""
    png_dir = os.path.join(assets, "png")
    pages = []
    if os.path.isdir(png_dir):
        for n in sorted(os.listdir(png_dir)):
            m = re.match(r"(.+?)_(.+)_text\.png$", n)
            if not m:
                continue
            man = m.group(1)
            if man not in _MANUSCRIPTS:
                continue
            pages.append((man, m.group(2), os.path.join(png_dir, n)))
    csvs, mapping = _find_csvs(assets)
    return pages, csvs, mapping


def _diff_json(ours: dict, ref: dict) -> str:
    """Structural diff: '' when identical in the ways that matter."""
    problems = []
    a, b = ours.get("syl_boxes", []), ref.get("syl_boxes", [])
    if len(a) != len(b):
        problems.append(f"syl count {len(a)} != reference {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.get("syl") != y.get("syl"):
            problems.append(
                f"syl[{i}] text {x.get('syl')!r} != {y.get('syl')!r}")
        elif [x.get("ul"), x.get("lr")] != [y.get("ul"), y.get("lr")]:
            problems.append(
                f"syl[{i}] {x.get('syl')!r} box {x.get('ul')}-{x.get('lr')}"
                f" != {y.get('ul')}-{y.get('lr')}")
        if len(problems) >= 6:
            problems.append("...")
            break
    ms_a = ours.get("median_line_spacing")
    ms_b = ref.get("median_line_spacing")
    if ms_a is not None and ms_b is not None and \
            abs(float(ms_a) - float(ms_b)) > 1e-9:
        problems.append(f"median_line_spacing {ms_a} != {ms_b}")
    return "; ".join(problems)


def verify(assets: str, manuscript: str | None = None, folios=None,
           backend: str = "hybrid", reuse_ocr: bool = True,
           verbose: bool = True) -> Report:
    from .lang import filename_to_text_func
    from .pipeline import process, to_JSON_dict

    pages, csvs, mapping = discover(assets)
    if manuscript:
        pages = [p for p in pages if p[0] == manuscript]
    if folios:
        wanted = {str(f) for f in folios}
        pages = [p for p in pages if p[1] in wanted]

    # reverse index fname -> transcript per manuscript
    transcripts: dict[tuple, str] = {}
    for man, csv_path in csvs.items():
        needs_map = _MANUSCRIPTS[man][1]
        tf = filename_to_text_func(
            csv_path, mapping if (needs_map and mapping) else None)
        for folio in getattr(tf, "folios", []):
            try:
                fname, text = tf(folio)
            except ValueError:
                continue
            transcripts[(man, fname)] = text

    report = Report()
    for man, fname, png_path in pages:
        full = f"{man}_{fname}"
        fr = FolioReport(full, man)
        report.folios.append(fr)
        text = transcripts.get((man, fname))
        if text is None:
            fr.status, fr.detail = "skipped", "no transcript in chant CSV"
            continue
        pik = os.path.join(assets, "pik", full + "_boxes.pickle")
        model = _find_model(assets, _MANUSCRIPTS[man][2])
        use_pik = reuse_ocr and os.path.isfile(pik)
        if not use_pik and model is None:
            fr.status = "skipped"
            fr.detail = "no OCR source (no pik cache, no .pyrnn.gz model)"
            continue
        fr.ocr_source = "pik" if use_pik else os.path.basename(model)
        from .textio import read_png

        raw = read_png(png_path)
        try:
            result = process(
                raw, text, ocropus_model=None if use_pik else model,
                existing_ocr_pickle=pik if use_pik else None,
                backend=backend, verbose=False)
        except Exception as e:
            fr.status, fr.detail = "error", repr(e)
            report.n_error += 1
            continue
        if result is None:
            fr.status, fr.detail = "error", "OCR produced nothing alignable"
            report.n_error += 1
            continue
        syl_boxes, _img, peaks, _chars = result
        ours = to_JSON_dict(syl_boxes, peaks)
        fr.n_syls = len(ours["syl_boxes"])

        ref_path = os.path.join(assets, "out_json", full + ".json")
        if os.path.isfile(ref_path):
            with open(ref_path) as f:
                ref = json.load(f)
            fr.ref_n_syls = len(ref.get("syl_boxes", []))
            diff = _diff_json(ours, ref)
            if diff:
                fr.status, fr.detail = "MISMATCH", diff
                report.n_mismatch += 1
            else:
                fr.status = "match"
                report.n_match += 1
        else:
            fr.status = "ran"
            fr.detail = "no reference out_json"
            report.n_no_reference += 1

        gt_path = os.path.join(assets, "ground-truth-alignments",
                               full + "_gt.xml")
        if os.path.isfile(gt_path):
            from .evaluate import evaluate_alignment, parse_gt_xml
            from .pipeline.preprocess import preprocess_images

            eval_img, _, _ = preprocess_images(
                raw, correct_rotation=False, backend=backend)
            fr.bbox_iou, fr.ink_iou = evaluate_alignment(
                parse_gt_xml(gt_path), ours["syl_boxes"], eval_img)
        if verbose:
            extra = ""
            if fr.ink_iou is not None:
                extra = f"  bbox IoU {fr.bbox_iou:.3f} ink {fr.ink_iou:.3f}"
            print(f"{full}: {fr.status} ({fr.ocr_source}, "
                  f"{fr.n_syls} syls){extra}"
                  + (f" — {fr.detail}" if fr.detail else ""))
    return report
