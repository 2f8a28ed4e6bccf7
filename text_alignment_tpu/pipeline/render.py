"""Overlay rendering — the reference's visual-regression surface
(draw_results_on_page, alignToOCR.py:354-375; save_preproc_image,
textAlignPreprocessing.py:425-448). The reference leaked a global ``fname``
(alignToOCR.py:374); here the output path is explicit.
"""

from __future__ import annotations

import numpy as np


from ..textio import pillow


def _font(size):
    ImageFont = pillow().ImageFont
    try:
        return ImageFont.truetype("FreeMono.ttf", size)
    except OSError:
        return ImageFont.load_default()


def _to_pil_grey(image: np.ndarray):
    if image.dtype == bool:
        arr = np.where(image, 0, 255).astype(np.uint8)
    else:
        arr = np.asarray(image).astype(np.uint8)
        if arr.ndim == 3:
            arr = arr.mean(axis=2).astype(np.uint8)
    return pillow().Image.fromarray(arr, mode="L")


def draw_results_on_page(image, syl_boxes, lines_peak_locs, out_path=None):
    """Render syllable boxes + line markers (alignToOCR.py:354-375)."""
    im = _to_pil_grey(image)
    text_size = max(10, im.width // 64)
    fnt = _font(text_size)
    draw = pillow().ImageDraw.Draw(im)

    for cbox in syl_boxes:
        if cbox.char in ". ":
            continue
        ul, lr = cbox.ul, cbox.lr
        draw.text((ul[0], ul[1] - text_size), cbox.char, font=fnt, fill="black")
        draw.rectangle([ul, lr], outline="black")
        draw.line([ul[0], ul[1], ul[0], lr[1]], fill="black", width=10)

    for i, peak_loc in enumerate(lines_peak_locs):
        draw.text((1, peak_loc - text_size), "line {}".format(i), font=fnt,
                  fill="gray")
        draw.line([0, peak_loc, im.width, peak_loc], fill="gray", width=3)

    if out_path:
        im.save(out_path)
    return im


def draw_boxes_on_page(image, bboxes, out_path=None, assign_lines=None):
    """MEI-enrichment debug overlay (writeToMEI.py:186-213): the zone
    bboxes assigned to syllable text, plus optional assignment lines."""
    im = _to_pil_grey(image)
    draw = pillow().ImageDraw.Draw(im)
    for ulx, uly, lrx, lry in bboxes:
        draw.rectangle([int(ulx), int(uly), int(lrx), int(lry)],
                       outline="black")
    for line in assign_lines or []:
        draw.line([int(v) for v in line], fill="gray", width=3)
    if out_path:
        im.save(out_path)
    return im


def save_preproc_image(image, cc_strips, lines_peak_locs, out_path=None):
    """Render detected strips + peaks (textAlignPreprocessing.py:425-448)."""
    im = _to_pil_grey(image).convert("RGB")
    text_size = 70
    fnt = _font(text_size)
    draw = pillow().ImageDraw.Draw(im)

    for i, peak_loc in enumerate(lines_peak_locs):
        draw.text((1, peak_loc - text_size), "line {}".format(i), font=fnt,
                  fill="gray")
        draw.line([0, peak_loc, im.width, peak_loc], fill="gray", width=3)

    for line in cc_strips:
        h, w = line.img.shape
        ul = (line.offset_x, line.offset_y)
        lr = (line.offset_x + w - 1, line.offset_y + h - 1)
        draw.rectangle([ul, lr], outline="black")

    if out_path:
        im.save(out_path)
    return im
