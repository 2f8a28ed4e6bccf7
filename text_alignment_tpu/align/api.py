"""Public alignment API: ``perform_alignment`` with selectable fill backend.

Same contract as the reference (textSeqCompare.py:13-177): takes element
lists (usually single characters), appends a ``' '`` sentinel to both,
fills the Gotoh matrices, and returns equal-length aligned element lists with
``'_'`` gap symbols.

Backends:
- ``"host"``   — numpy fill (exact oracle / CPU baseline).
- ``"jax"``    — anti-diagonal wavefront fill and traceback on the default
  JAX device, the O(N+M) op stream streamed back for host replay.
- ``"auto"``   — jax when available and the problem is big enough to amortize
  dispatch, else host.
"""

from __future__ import annotations

from .scoring import resolve_scoring
from .nw_host import fill_host
from .traceback import DensePtrView, DiagPtrView, traceback

# problems smaller than this run on the host fill under backend="auto"
# (512*512 when the native engine is unavailable and the slower numpy
# fill runs instead)
_AUTO_DEVICE_MIN_CELLS = 2048 * 2048
_AUTO_DEVICE_MIN_CELLS_NUMPY = 512 * 512


def auto_device_min_cells() -> int:
    from .nw_host import _native_nw_available

    return (_AUTO_DEVICE_MIN_CELLS if _native_nw_available()
            else _AUTO_DEVICE_MIN_CELLS_NUMPY)


def align_grid(transcript, ocr, params_list, mesh=None):
    """One (transcript, ocr) pair aligned under MANY integer scoring rows
    [match, mismatch, gox, goy, gex, gey] — the 729-combination grid
    search (evaluate_text_alignment.py:181-189) as batched lock-step
    wavefronts (the vmapped XLA scan), bit-identical to the host loop.
    ``mesh`` shards the parameter axis over the mesh's 'data' axis (each
    device fills its share of the grid — the multi-device fan-out for
    parameter sweeps; bit-identical, tested). Returns a list of
    (tra_align, ocr_align) per row."""
    from .nw_jax import align_grid_jax

    return align_grid_jax(transcript, ocr, params_list, mesh=mesh)


def perform_alignment(transcript, ocr, scoring_system=None, verbose=False,
                      backend="auto", strict=True):
    """Globally align ``transcript`` against ``ocr``.

    Both arguments are lists of hashable elements (typically 1-char strings).
    Returns ``(tra_align, ocr_align)`` lists of equal length.
    ``strict=False`` replaces the reference's stale boundary gap extend
    with the scoring system's own extends (align.scoring docstring).
    """
    transcript = list(transcript) + [" "]
    ocr = list(ocr) + [" "]

    sc = resolve_scoring(scoring_system, strict=strict)

    if backend == "auto":
        if len(transcript) * len(ocr) >= auto_device_min_cells():
            backend = "jax"
        else:
            backend = "host"

    if backend == "host":
        ptrs = DensePtrView(*fill_host(transcript, ocr, sc))
        tra_align, ocr_align = traceback(transcript, ocr, ptrs)
    elif backend == "jax":
        from .nw_jax import align_jax_ops, replay_ops

        ops, count, xpt, ypt = align_jax_ops(transcript, ocr, sc)
        tra_align, ocr_align = replay_ops(transcript, ocr, ops, count, xpt, ypt)
    elif backend == "reference":
        from .nw_host import fill_reference_slow

        ptrs = DensePtrView(*fill_reference_slow(transcript, ocr, sc))
        tra_align, ocr_align = traceback(transcript, ocr, ptrs)
    else:
        raise ValueError("unknown backend {!r}".format(backend))

    if verbose:
        for n in range(len(tra_align)):
            marker = "O" if tra_align[n] == ocr_align[n] else "~"
            print("{} {} {}".format(tra_align[n], ocr_align[n], marker))

    return tra_align, ocr_align
