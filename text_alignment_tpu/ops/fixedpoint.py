"""Shared fixed-point integer angle math for skew detection and rotation.

The host oracle and the device kernels must produce *identical* pixels, but
float32 (device) vs float64 (numpy) trig would disagree on rounding at pixel
boundaries. Instead, all trig is evaluated once on the host in float64, then
quantized to Q16 fixed point; both paths evaluate the same integer formula
(int32-safe for page dimensions up to 8192), making rotation and shear
bit-reproducible across backends.

Max |intermediate|: 2^16 (scale) * 8192 (coord) = 2^29 < int32 max.
"""

from __future__ import annotations

import math

import numpy as np

SCALE_BITS = 16
SCALE = 1 << SCALE_BITS


def angle_grid(lo: float, hi: float, step: float) -> list[float]:
    """Inclusive grid of candidate angles, rounded to avoid float drift."""
    n = int(round((hi - lo) / step))
    return [round(lo + i * step, 6) for i in range(n + 1)]


def shear_shifts(angle_deg: float, width: int) -> np.ndarray:
    """Per-column vertical shifts for shear-projection skew scoring:
    shift[x] = round(-tan(angle) * (x - W/2)), via Q16 integers.

    The sign is chosen so the detected angle is the *corrective* one: a page
    whose lines slope like a rotation by theta scores highest at -theta, and
    ``rotate(detected)`` levels the lines — matching how the reference uses
    Gamera's estimate (textAlignPreprocessing.py:183-185)."""
    t = int(round(-math.tan(math.radians(angle_deg)) * SCALE))
    x = np.arange(width, dtype=np.int64) - width // 2
    return ((t * x + (SCALE // 2)) >> SCALE_BITS).astype(np.int32)


def shear_shifts_batch(angles, width: int) -> np.ndarray:
    """:func:`shear_shifts` for a whole candidate grid in one (A, W) outer
    product. The per-angle Q16 tangent stays the scalar ``int(round(...))``
    (python round, not np.round's fast-path) so every row is bit-identical
    to the per-angle call."""
    ts = np.array(
        [int(round(-math.tan(math.radians(a)) * SCALE)) for a in angles],
        np.int64,
    )
    x = np.arange(width, dtype=np.int64) - width // 2
    return ((ts[:, None] * x + (SCALE // 2)) >> SCALE_BITS).astype(np.int32)


CANVAS_QUANTUM = 32


def rotated_canvas(H: int, W: int, angle_deg: float) -> tuple[int, int]:
    """Expanded canvas size for a rotation (grow-to-fit), rounded up to a
    CANVAS_QUANTUM multiple. Quantizing is canonical (both backends): it
    keeps the rotated-page shape stable across nearby detected angles, so
    every downstream jitted kernel compiles once per page geometry instead
    of once per folio. The extra padding is symmetric white margin, which
    rotate_bbox's (orig - target) // 2 compensation already absorbs
    (alignToOCR.py:93-96)."""
    r = math.radians(angle_deg)
    c, s = abs(math.cos(r)), abs(math.sin(r))
    W2 = int(math.ceil(W * c + H * s))
    H2 = int(math.ceil(H * c + W * s))
    q = CANVAS_QUANTUM
    return ((H2 + q - 1) // q) * q, ((W2 + q - 1) // q) * q


def rotation_coeffs(angle_deg: float) -> tuple[int, int]:
    """Q16 (cos, sin) of the angle."""
    r = math.radians(angle_deg)
    return int(round(math.cos(r) * SCALE)), int(round(math.sin(r) * SCALE))


def inverse_rotation_map(H: int, W: int, H2: int, W2: int, angle_deg: float,
                         xp=np):
    """Integer inverse map for nearest-neighbor rotation: for each output
    pixel (y2, x2) of the H2 x W2 canvas, the source (y, x) in the H x W
    input. Centered pivots; out-of-range sources indicate background.

    ``xp`` may be numpy or jax.numpy — the formula is identical, which is
    what guarantees host/device parity.
    """
    cfix, sfix = rotation_coeffs(angle_deg)
    # pivot at pixel-center of each image, in Q1 halves to stay integral
    # 2*dx = 2*x2 - (W2 - 1), etc.
    x2 = xp.arange(W2, dtype=xp.int32)[None, :]
    y2 = xp.arange(H2, dtype=xp.int32)[:, None]
    dx2 = 2 * x2 - (W2 - 1)  # doubled offsets, int
    dy2 = 2 * y2 - (H2 - 1)
    # inverse rotation: src = R(-a) . d  (doubled, Q16)
    sx2 = cfix * dx2 + sfix * dy2
    sy2 = -sfix * dx2 + cfix * dy2
    # back to pixel coords: x = (sx2 / 2^16 + (W-1)) / 2, rounded to nearest
    src_x = (sx2 + (W - 1) * SCALE + SCALE) >> (SCALE_BITS + 1)
    src_y = (sy2 + (H - 1) * SCALE + SCALE) >> (SCALE_BITS + 1)
    return src_y, src_x
