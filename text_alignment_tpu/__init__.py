"""text_alignment_tpu — a JAX/XLA text-alignment framework.

Given an image of the text layer of a chant manuscript and a transcript of the
chant text on that page, locates every syllable of the transcript on the page
and emits a JSON list of syllable bounding boxes (capability parity with the
reference pipeline documented in SURVEY.md; reference: alignToOCR.py:187-351).

Layer map (batched device stages, not a translation):

- ``ops``       — batched image kernels over page tensors (binarize, despeckle,
                  connected components, run filters, skew/rotate, projections);
                  replaces the reference's Gamera C++ plugin calls.
- ``models``    — BiLSTM+CTC line recognizer (`lax.scan` over frames, batched
                  over bucketed line crops) + ``.pyrnn.gz`` weight loading;
                  replaces the `ocropus-rpred` subprocess.
- ``align``     — affine-gap Needleman–Wunsch: anti-diagonal wavefront fill on
                  device, host traceback; replaces textSeqCompare.py's O(N·M)
                  Python loop.
- ``lang``      — Latin syllabification + CANTUS CSV ingestion (host-side,
                  exact reference semantics).
- ``pipeline``  — orchestration: `process()` with the reference's public
                  return contract, JSON emission, assembly.
- ``parallel``  — device-mesh sharding (data parallelism over folios/lines).
- ``utils``     — stage timing/tracing, caches.
"""

__version__ = "0.1.0"

# Persistent XLA compilation cache: enabled lazily and only for accelerator
# backends, via utils.compile_cache.ensure_compile_cache() — called from the
# device-facing entry points right before their first jit (see that module).

from .charbox import CharBox
from .textio import read_file
from .utils.compile_cache import ensure_compile_cache

__all__ = ["CharBox", "read_file", "ensure_compile_cache", "__version__"]
