"""Synthetic manuscript-page generator for tests and benchmarks.

The reference's data (png pages, CANTUS CSVs, trained pyrnn models) is not
distributable with this repo (SURVEY.md §0: large blobs stripped, data dirs
gitignored), so fixtures are generated: pages with glyph-like ink laid out
in text lines at known positions, optional skew, speckle noise, and matching
ground-truth OCR character streams for stage-injection tests (the
generalization of the reference's OCR-pickle trick, alignToOCR.py:225-233).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .charbox import CharBox


@dataclass
class SynthPage:
    image: np.ndarray            # uint8 RGB (H, W, 3), white bg / black ink
    transcript: str              # space-separated lowercase words
    char_boxes: list = field(default_factory=list)  # CharBox ground truth
    line_baselines: list = field(default_factory=list)
    angle: float = 0.0           # applied skew, degrees


def _glyph(rng, h, w):
    """A dense glyph-like blob that binarizes to one connected component."""
    g = np.zeros((h, w), dtype=bool)
    g[:, : max(1, w // 3)] = True  # vertical stem
    g[h // 2 : h // 2 + max(2, h // 4), :] = True  # crossbar
    extra = rng.random((h, w)) < 0.35
    g |= extra
    # connect: dilate-ish by or-ing shifts
    g[1:] |= g[:-1]
    g[:, 1:] |= g[:, :-1]
    return g


def _char_glyph(ch: str, h: int, w: int, rng=None):
    """A deterministic, character-identifiable glyph: stroke pattern seeded
    by the character, plus light per-occurrence noise. Lets a recognizer
    actually LEARN the synthetic font (the random blob above is
    char-independent by design — good for raster tests, unlearnable)."""
    crng = np.random.default_rng(ord(ch) * 2654435761 % (2**32))
    g = np.zeros((h, w), dtype=bool)
    g[:, : max(1, w // 4)] = True  # common stem keeps the CC connected
    # 3 character-specific horizontal bars + 2 vertical strokes
    for _ in range(3):
        y = int(crng.integers(0, max(1, h - 2)))
        g[y : y + 2, :] = True
    for _ in range(2):
        x = int(crng.integers(0, max(1, w - 2)))
        y0 = int(crng.integers(0, h // 2))
        g[y0 : y0 + h // 2, x : x + 2] = True
    if rng is not None:  # per-occurrence speckle noise (light)
        g |= rng.random((h, w)) < 0.04
    g[1:] |= g[:-1]
    return g


def make_page(rng=None, n_lines: int = 6, words_per_line: int = 4,
              H: int = 560, W: int = 800, char_h: int = 18, char_w: int = 11,
              gap: int = 3, space_w: int = 18, angle: float = 0.0,
              speckles: int = 60, margin_x: int = 40,
              line_spacing: int | None = None,
              vocabulary=("dominus", "deus", "alleluia", "sanctus", "gloria",
                          "kyrie", "angelus", "maria", "in", "excelsis",
                          "benedictus", "magnificat"),
              glyphs: str = "random") -> SynthPage:
    """Render a synthetic text page. Ground-truth char boxes are in the
    *unrotated* page frame when angle == 0 (tests inject OCR at that stage)."""
    rng = rng or np.random.default_rng(0)
    img = np.zeros((H, W), dtype=bool)
    spacing = line_spacing or (H - 100) // n_lines
    boxes: list[CharBox] = []
    baselines = []
    words_all = []

    for li in range(n_lines):
        y0 = 50 + li * spacing
        baselines.append(y0 + char_h // 2)
        x = margin_x + int(rng.integers(0, 30))
        line_words = [
            str(rng.choice(vocabulary)) for _ in range(words_per_line)
        ]
        for wi, word in enumerate(line_words):
            # keep transcript == rendered char stream: a word that would
            # hit the right margin is skipped entirely, so neither the page
            # nor the ground truth ever contains truncated fragments
            end_x = x + len(word) * (char_w + gap) - gap
            if end_x >= W - margin_x:
                continue
            for ch in word:
                # vertical jitter keeps projections from forming perfectly
                # flat plateaus (real ink never does; exactly-equal
                # prominences would trip the reference's flat-top dedup)
                jy = int(rng.integers(-2, 3))
                if glyphs == "char":
                    g = _char_glyph(ch, char_h, char_w, rng)
                else:
                    g = _glyph(rng, char_h, char_w)
                img[y0 + jy : y0 + jy + char_h, x : x + char_w] |= g
                # ground-truth boxes use line-constant y like real
                # strip-derived OCR boxes do (alignToOCR.py:160-173)
                boxes.append(CharBox(ch, (x, y0), (x + char_w, y0 + char_h)))
                x += char_w + gap
            words_all.append(word)
            x += space_w

    # speckle noise (small enough for despeckle to eat)
    for _ in range(speckles):
        y, x = int(rng.integers(0, H)), int(rng.integers(0, W))
        img[y : y + 2, x : x + 2] = True

    if angle != 0.0:
        from .ops import oracle

        img = oracle.rotate_onebit(img, angle)

    rgb = np.where(img[..., None], 0, 255).astype(np.uint8)
    rgb = np.repeat(rgb, 3, axis=2)
    transcript = " ".join(words_all)
    return SynthPage(rgb, transcript, boxes, baselines, angle)


def bench_page(seed: int) -> SynthPage:
    """A bench-sized folio: 2000x1600, 10 lines of 3 words, 70x40 glyphs,
    speckles and a 0.8 degree skew (the benchmark's and the GPU smoke
    test's page geometry)."""
    return make_page(
        np.random.default_rng(seed), n_lines=10, words_per_line=3,
        H=2000, W=1600, char_h=70, char_w=40, gap=8, space_w=60,
        line_spacing=180, speckles=200, margin_x=60, angle=0.8,
    )


def corrupt_ocr(rng, char_boxes, sub_rate=0.08, del_rate=0.03,
                alphabet="abcdefghijklmnopqrstuvwxyz"):
    """Simulate OCR errors over the ground-truth char stream: the aligner's
    job is to undo exactly this kind of damage (README.md:26-34)."""
    out = []
    for cb in char_boxes:
        r = rng.random()
        if r < del_rate:
            continue
        ch = cb.char
        if r < del_rate + sub_rate:
            ch = str(rng.choice(list(alphabet)))
        out.append(CharBox(ch, cb.ul, cb.lr))
    return out


def ocr_with_spaces(char_boxes, space_gap: int = 12):
    """Insert ' ' CharBoxes at word gaps, approximating how a real line
    recognizer emits spaces between words."""
    out = []
    prev = None
    for cb in char_boxes:
        if (
            prev is not None
            and cb.uly == prev.uly
            and cb.ulx - prev.lrx >= space_gap
        ):
            out.append(CharBox(" ", (prev.lrx, prev.uly), (cb.ulx, prev.lry)))
        elif prev is not None and cb.uly != prev.uly:
            out.append(CharBox(" ", (prev.lrx, prev.uly), (prev.lrx + 5, prev.lry)))
        out.append(cb)
        prev = cb
    return out
