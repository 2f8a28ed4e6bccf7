"""Rodan job wrapper (textAlignment.py equivalent).

The reference registers a `RodanTask` with a Text Layer (image/rgba+png) +
Transcript (text/plain) input and a JSON output (textAlignment.py:29-49).
Rodan itself is not a dependency here, so the task class is built only when
`rodan` is importable; the schema constants and the task body are importable
and testable regardless.

NB the reference's run_my_task calls process() without the required
ocropus_model argument and unpacks 3 of 4 return values — a stale call that
would TypeError (textAlignment.py:56, SURVEY.md §2.14). This wrapper is the
corrected behavior: the model path comes from job settings.
"""

from __future__ import annotations

import json

import numpy as np

from .pipeline import process, to_JSON_dict
from .textio import read_file

JOB_NAME = "Text Alignment"
JOB_AUTHOR = "text_alignment_tpu"
JOB_DESCRIPTION = (
    "Given a text layer image and plaintext of some text on that page, "
    "finds the position of each syllable of that text on the page"
)
JOB_CATEGORY = "text"

SETTINGS = {
    "title": "Text Alignment Settings",
    "type": "object",
    "required": ["MEI Version"],
    "properties": {
        "MEI Version": {
            "enum": ["4.0.0", "3.9.9"],
            "type": "string",
            "default": "3.9.9",
            "description": (
                "Specifies the MEI version, 3.9.9 is the old unofficial MEI "
                "standard used by Neon"
            ),
        },
        "OCR Model": {
            "type": "string",
            "default": "./salzinnes_model-00054500.pyrnn.gz",
            "description": "Path to the .pyrnn.gz line-recognizer model",
        },
    },
}

INPUT_PORT_TYPES = [
    {
        "name": "Text Layer",
        "resource_types": ["image/rgba+png"],
        "minimum": 1,
        "maximum": 1,
        "is_list": False,
    },
    {
        "name": "Transcript",
        "resource_types": ["text/plain"],
        "minimum": 1,
        "maximum": 1,
        "is_list": False,
    },
]

OUTPUT_PORT_TYPES = [
    {
        "name": "JSON",
        "resource_types": ["application/JSON"],
        "minimum": 1,
        "maximum": 1,
        "is_list": False,
    }
]

# resource_types.yaml:1-9 equivalent
RESOURCE_TYPES = [
    {"mimetype": "image/rgba+png", "description": "Text layer image"},
    {"mimetype": "text/plain", "description": "Chant transcript"},
    {"mimetype": "application/JSON", "description": "Syllable boxes"},
]


def load_text_layer(path: str) -> np.ndarray:
    from .textio import read_png

    return read_png(path)


def run_task(inputs: dict, settings: dict, outputs: dict,
             backend: str = "device") -> bool:
    """The task body (textAlignment.py:51-63, corrected)."""
    transcript = read_file(inputs["Transcript"][0]["resource_path"])
    raw_image = load_text_layer(inputs["Text Layer"][0]["resource_path"])

    model = settings.get("OCR Model", SETTINGS["properties"]["OCR Model"]["default"])
    result = process(raw_image, transcript, ocropus_model=model,
                     verbose=False, backend=backend)
    if result is None:
        return False
    syl_boxes, _, lines_peak_locs, _ = result

    outfile_path = outputs["JSON"][0]["resource_path"]
    with open(outfile_path, "w") as f:
        json.dump(to_JSON_dict(syl_boxes, lines_peak_locs), f)
    return True


def make_rodan_task():
    """Build the RodanTask subclass when running inside Rodan."""
    from rodan.jobs.base import RodanTask  # pragma: no cover

    class textAlignment(RodanTask):  # noqa: N801 (Rodan naming convention)
        name = JOB_NAME
        author = JOB_AUTHOR
        description = JOB_DESCRIPTION
        enabled = True
        category = JOB_CATEGORY
        interactive = False
        settings = SETTINGS
        input_port_types = INPUT_PORT_TYPES
        output_port_types = OUTPUT_PORT_TYPES

        def run_my_task(self, inputs, settings, outputs):
            return run_task(inputs, settings, outputs)

    return textAlignment
