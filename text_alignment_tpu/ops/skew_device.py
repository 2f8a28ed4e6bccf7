"""Device-offloaded coarse-to-fine skew search (one dispatch per page).

The hybrid raster's skew estimate (Gamera ``rotation_angle_projections``
semantics, reference textAlignPreprocessing.py:183) is the biggest host
item of the native raster in the batched pipeline. This module moves the whole three-round search onto the accelerator as ONE
async dispatch per page, so it hides under the next folio's host raster:

- The host packs the post-stage-1 page to bits (np.packbits) and uploads
  ~W*H/8 bytes instead of running three shear-projection rounds.
- Rounds 2 and 3 normally need the host in the loop (their candidate grids
  depend on the previous round's winner). Instead, every reachable
  candidate angle is precomputed on the HOST in float64 as a Q16 tangent
  *decision tree* — round 1 has A1 winners, so there are only A1*19 round-2
  and A1*19*19 round-3 candidate angles — and the whole tree rides into
  the jitted program as static int32 constants. The device walks the tree
  with two gathers; the download is three int32 indices, which the host
  maps back to the float angle with the same ``fxp.angle_grid`` arithmetic
  the host search uses.
- Bit-exactness: shifts use the shared Q16 integer formula
  (``fxp.shear_shifts``); projections are integer-exact f32 matmul counts
  (one-hot operands and integer counts below 2^24 are exact in f32, and
  every product asks for HIGHEST precision — full f32, never TF32); the squared-derivative criterion (oracle.criterion_from_
  projections, exact int64 on host) is carried as a canonical two-limb
  int32 pair (hi = total >> 16, lo = total & 0xffff), compared
  lexicographically with first-max-wins — bit-identical to the host
  argmax. Parity is fuzz-tested in tests/test_skew_device.py.

Per-angle schedule: the sheared row projection
``proj[y] = sum_x img[y + shift[x], x]`` is computed as a *blocked one-hot
matmul* plus a masked roll ladder. Within a 128-column block the Q16 shift
ramp spans at most ``(max_t*127 >> 16) + 1`` distinct values (~16 at the
6-degree extreme), so the one-hot contraction is (128 -> V~17) per block —
~16x fewer FLOPs than a full-range one-hot — and the per-(block, v) column
sums are then aligned by a log2 masked-roll ladder and summed. All counts
stay < 2^24 so f32 is exact end to end.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

from . import fixedpoint as fxp

_A23 = 19  # rounds 2/3 grid size: int(round(2*0.9/0.1)) + 1, fixed by recipe


def _qtan(angle_deg: float) -> int:
    """The Q16 tangent ``fxp.shear_shifts`` uses (host float64 + python
    round — the device never evaluates trig)."""
    return int(round(-math.tan(math.radians(angle_deg)) * fxp.SCALE))


@functools.lru_cache(maxsize=None)
def _tan_tree(minangle: float, maxangle: float):
    """(t1 (A1,), t2 (A1, 19), t3 (A1, 19, 19)) int32 Q16 tangents of every
    candidate angle reachable by the coarse-to-fine recipe (step 1.0 over
    [minangle, maxangle], then best +- 0.9 step 0.1, then best +- 0.09 step
    0.01 — oracle.rotation_angle_projections)."""
    c1 = fxp.angle_grid(minangle, maxangle, 1.0)
    a1 = len(c1)
    t1 = np.array([_qtan(a) for a in c1], np.int32)
    t2 = np.empty((a1, _A23), np.int32)
    t3 = np.empty((a1, _A23, _A23), np.int32)
    for i, b1 in enumerate(c1):
        c2 = fxp.angle_grid(b1 - 0.9, b1 + 0.9, 0.1)
        assert len(c2) == _A23
        t2[i] = [_qtan(a) for a in c2]
        for j, b2 in enumerate(c2):
            c3 = fxp.angle_grid(b2 - 0.09, b2 + 0.09, 0.01)
            assert len(c3) == _A23
            t3[i, j] = [_qtan(a) for a in c3]
    return t1, t2, t3


def angle_from_indices(i1: int, i2: int, i3: int,
                       minangle: float = -6.0,
                       maxangle: float = 6.0) -> float:
    """Map the device's per-round winner indices back to the float angle —
    the same float64 grid arithmetic as the host search, so the result is
    bit-identical to oracle/host_native.rotation_angle_projections."""
    c1 = fxp.angle_grid(minangle, maxangle, 1.0)
    b1 = c1[int(i1)]
    c2 = fxp.angle_grid(b1 - 0.9, b1 + 0.9, 0.1)
    b2 = c2[int(i2)]
    c3 = fxp.angle_grid(b2 - 0.09, b2 + 0.09, 0.01)
    return float(c3[int(i3)])


@functools.lru_cache(maxsize=None)
def _make_search(Hp: int, Wp: int, minangle: float, maxangle: float):
    """Build the raw (imgb, h, w) -> (3,) int32 winner-index function over
    an already-unpacked (Hp, Wp//128, 128) float32 {0,1} page — the form
    the fused device raster (ops.raster_device) composes directly, no
    pack/unpack round trip. ``_make_single`` wraps it for packed-bit
    callers."""
    import jax
    import jax.numpy as jnp

    t1, t2, t3 = _tan_tree(minangle, maxangle)
    max_t = int(max(np.abs(t1).max(), np.abs(t2).max(), np.abs(t3).max()))
    nb = Wp // 128
    V = (max_t * 127 >> fxp.SCALE_BITS) + 2   # in-block shift spread bound
    maxsh = (max_t * Wp >> fxp.SCALE_BITS) + 2  # global |shift| bound
    P = 1
    while P < maxsh + 1:
        P *= 2
    LB = (2 * P - 1).bit_length()             # roll-ladder bit count
    half = jnp.int32(fxp.SCALE // 2)

    t1j = jnp.asarray(t1)
    t2j = jnp.asarray(t2)
    t3j = jnp.asarray(t3)
    varange = jnp.arange(V, dtype=jnp.int32)

    def score_angle(imgb, h, w, t):
        # imgb: (Hp, nb, 128) f32 exact {0,1}; h, w, t: () int32
        x = jnp.arange(Wp, dtype=jnp.int32) - w // 2
        shift = (t * x + half) >> fxp.SCALE_BITS        # (Wp,) == fxp ramp
        sb = shift.reshape(nb, 128)
        bmin = jnp.min(sb, axis=1)                      # (nb,)
        onehot = (
            (sb - bmin[:, None])[:, :, None] == varange
        ).astype(jnp.float32)                           # (nb, 128, V)
        G = jnp.einsum("hnw,nwv->hnv", imgb, onehot,
                       precision=jax.lax.Precision.HIGHEST)
        Gf = G.reshape(Hp, nb * V)
        # column (n, v) holds the summed img columns whose shift is
        # bmin[n] + v; align each by its shift with a masked roll ladder
        # (out[y] = Gp[y + r + P], zero-padded, no wraparound by P bound)
        k = (bmin[:, None] + varange[None, :]).reshape(nb * V) + P
        acc = jnp.pad(Gf, ((P, P), (0, 0)))
        bit = 1
        for _ in range(LB):
            acc = jnp.where((k & bit)[None, :] != 0,
                            jnp.roll(acc, -bit, axis=0), acc)
            bit *= 2
        proj = jnp.sum(acc[:Hp], axis=1)                # (Hp,) exact ints
        d = proj[1:] - proj[:-1]
        mask = jnp.arange(Hp - 1, dtype=jnp.int32) < (h - 1)
        # square AFTER the int cast: d itself is an exact integer in f32
        # (|d| <= W <= 2^24), but d*d in f32 rounds once |d| > 4096,
        # which would break bit-parity with the host's exact criterion
        # on very wide pages with sharp full-width ink edges
        di = d.astype(jnp.int32)
        d2 = jnp.where(mask, di * di, 0)
        # criterion = sum(d^2) <= H*W^2 (~2^34): exact two-limb int32,
        # canonicalized so lexicographic (hi, lo) compare == numeric
        hi = jnp.sum(d2 >> 16)
        lo = jnp.sum(d2 & 0xFFFF)
        return hi + (lo >> 16), lo & 0xFFFF

    def run_round(imgb, h, w, ts):
        def step(carry, t):
            bh, bl, bi, i = carry
            hi, lo = score_angle(imgb, h, w, t)
            better = (hi > bh) | ((hi == bh) & (lo > bl))  # first-max wins
            return (jnp.where(better, hi, bh), jnp.where(better, lo, bl),
                    jnp.where(better, i, bi), i + 1), None

        init = (jnp.int32(-1), jnp.int32(-1), jnp.int32(0), jnp.int32(0))
        (_, _, bi, _), _ = jax.lax.scan(step, init, ts)
        return bi

    def search(imgb, h, w):
        i1 = run_round(imgb, h, w, t1j)
        i2 = run_round(imgb, h, w, t2j[i1])
        i3 = run_round(imgb, h, w, t3j[i1, i2])
        return jnp.stack([i1, i2, i3])

    return search


@functools.lru_cache(maxsize=None)
def _make_single(Hp: int, Wp: int, minangle: float, maxangle: float):
    """Build the raw (packed_bits, h, w) -> (3,) int32 winner-index
    function for one padded page geometry (jit/vmap applied by callers)."""
    import jax.numpy as jnp

    search = _make_search(Hp, Wp, minangle, maxangle)
    nb = Wp // 128

    def fn(packed, h, w):
        shifts32 = jnp.arange(32, dtype=jnp.uint32)
        bits = (packed.astype(jnp.uint32)[..., None] >> shifts32) & 1
        imgb = bits.reshape(Hp, nb, 128).astype(jnp.float32)
        return search(imgb, h, w)

    return fn


@functools.lru_cache(maxsize=None)
def _skew_fn(Hp: int, Wp: int, minangle: float, maxangle: float):
    """Jitted single-page program (tests + the synchronous wrapper)."""
    import jax

    return jax.jit(_make_single(Hp, Wp, minangle, maxangle))


@functools.lru_cache(maxsize=None)
def _skew_fn_batched(G: int, Hp: int, Wp: int, minangle: float,
                     maxangle: float):
    """Jitted (G, Hp + 1, Wp // 32) int32 -> (G, 3) int32 grouped program.
    Rows [0, Hp) of each page are little-endian bits; the last row carries
    (h, w) in its first two lanes so a group is ONE host->device transfer
    (same wire trick as the OCR dispatch, models/recognizer.py)."""
    import jax

    single = _make_single(Hp, Wp, minangle, maxangle)

    @jax.jit
    def fn(packed_meta):
        hs = packed_meta[:, -1, 0]
        ws = packed_meta[:, -1, 1]
        return jax.vmap(single)(packed_meta[:, :-1], hs, ws)

    return fn


def enabled() -> bool:
    """Whether the pipelined batched raster should use the device skew
    path (TEXT_ALIGNMENT_TPU_SKEW=host|device|auto; auto routes by
    platform via utils.platform — on XLA:CPU the search is correct but
    slower than the native host engine, so only tests force it there)."""
    mode = os.environ.get("TEXT_ALIGNMENT_TPU_SKEW", "auto")
    if mode in ("host", "device"):
        return mode == "device"
    from ..utils.platform import engine

    return engine("skew") == "device"


def dispatch(img_u8: np.ndarray, minangle: float = -6.0,
             maxangle: float = 6.0):
    """Pack + upload + dispatch the full skew search for one 0/1 uint8
    page. Returns an opaque handle; redeem with :func:`collect`. The
    device work (and the jax dispatch itself) is async — the host returns
    after the upload."""
    import jax.numpy as jnp

    H, W = img_u8.shape
    Hp = -(-H // 16) * 16
    Wp = -(-W // 128) * 128
    bits = np.zeros((Hp, Wp // 8), np.uint8)
    bits[:H, : (W + 7) // 8] = np.packbits(img_u8, axis=1, bitorder="little")
    packed = bits.view(np.int32).reshape(Hp, Wp // 32)
    fn = _skew_fn(Hp, Wp, minangle, maxangle)
    idx = fn(jnp.asarray(packed), jnp.int32(H), jnp.int32(W))
    return idx, (minangle, maxangle)


def collect(handle) -> float:
    """Block on a :func:`dispatch` handle and return the detected angle
    (bit-identical to the host search's float)."""
    idx, (mn, mx) = handle
    i1, i2, i3 = np.asarray(idx).tolist()
    return angle_from_indices(i1, i2, i3, mn, mx)


def rotation_angle_projections(img, minangle: float = -6.0,
                               maxangle: float = 6.0) -> float:
    """Synchronous convenience wrapper (oracle signature)."""
    return collect(dispatch(np.ascontiguousarray(
        np.asarray(img), dtype=np.uint8), minangle, maxangle))


class GroupedSkewWorker:
    """Grouped async skew searches for the stage-major batched raster.

    A dispatch and a result pull per page cost host time and latency
    that can exceed the host search they replace. This worker amortizes
    them with the same two tricks the pipelined OCR stage uses
    (parallel.batch.PipelinedOCRWorker):

    - pages batch into groups of ``group`` (same padded geometry), so the
      upload and program launch amortize (ONE transfer per group, h/w
      riding a metadata row);
    - a collector thread pulls each group's (G, 3) winner indices off the
      caller's thread (the wait releases the GIL), so the pull latency
      hides under the raster of later folios.

    Protocol: ``put(img)`` per 0/1 uint8 page (returns a slot id), then
    ``finish()`` exactly once after the last put (flushes partial groups —
    padded slots are blank pages — and lets the collector exit), then
    ``angle(slot)`` per page (blocks until that group's pull lands).
    ``finish()`` is idempotent and must also be called on abandon so a
    long-lived server never leaks the collector thread."""

    def __init__(self, group: int = 4, minangle: float = -6.0,
                 maxangle: float = 6.0):
        import queue
        import threading

        self._mn, self._mx = minangle, maxangle
        self._group = group
        self._bufs: dict = {}    # (Hp, Wp) -> [meta array, slot list]
        self._n = 0
        self._angles: dict = {}
        self._cv = threading.Condition()
        self._q: queue.Queue = queue.Queue()
        self._finished = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            slots, handle = item
            try:
                idx = np.asarray(handle)
                res = [angle_from_indices(*row, self._mn, self._mx)
                       for row in idx[: len(slots)].tolist()]
            except BaseException as e:  # re-raised at angle()
                res = [e] * len(slots)
            with self._cv:
                for s, a in zip(slots, res):
                    self._angles[s] = a
                self._cv.notify_all()

    def _reserve(self, H: int, W: int):
        """Group slot for an H x W page: (bits8 view to pack into, commit
        thunk). The meta buffer is freshly zeroed, so packers may OR ink
        bits without clearing."""
        Hp = -(-H // 16) * 16
        Wp = -(-W // 128) * 128
        key = (Hp, Wp)
        buf = self._bufs.get(key)
        if buf is None:
            meta = np.zeros((self._group, Hp + 1, Wp // 32), np.int32)
            buf = self._bufs[key] = [meta, []]
        meta, slots = buf
        b = len(slots)
        bits8 = meta[b, :Hp].view(np.uint8).reshape(Hp, Wp // 8)
        meta[b, Hp, 0] = H
        meta[b, Hp, 1] = W
        slot = self._n
        self._n += 1
        slots.append(slot)

        def commit():
            if len(slots) == self._group and key in self._bufs:
                self._flush(key)
            return slot

        return bits8, commit

    def put(self, img_u8: np.ndarray) -> int:
        H, W = img_u8.shape
        bits8, commit = self._reserve(H, W)
        bits8[:H, : (W + 7) // 8] = np.packbits(img_u8, axis=1,
                                                bitorder="little")
        return commit()

    def put_runs(self, runs: np.ndarray, n: int, H: int, W: int) -> int:
        """put() without the page re-read: OR the phase-1 run list's ink
        bits straight into the zeroed group buffer (native engine only)."""
        from . import host_native as hn

        bits8, commit = self._reserve(H, W)
        hn.pack_runs_into(runs, n, bits8)
        return commit()

    def _flush(self, key):
        meta, slots = self._bufs.pop(key)
        Hp, Wp = key
        fn = _skew_fn_batched(self._group, Hp, Wp, self._mn, self._mx)
        handle = fn(meta)  # implicit upload + async dispatch
        self._q.put((list(slots), handle))

    def finish(self):
        if self._finished:
            return
        self._finished = True
        try:
            for key in list(self._bufs):
                self._flush(key)
        finally:
            self._q.put(None)  # the collector must exit even if a flush died

    def angle(self, slot: int) -> float:
        # If the slot still sits in a partial buffer, dispatch that group
        # NOW (padded): the caller is about to block and cannot enqueue
        # the pages that would have completed the group — with diverse
        # page geometries the group might never fill, which would
        # deadlock the stream (each (Hp, Wp) bucket buffers separately,
        # so a lookahead window of mixed sizes can hold only partial
        # groups). put/angle run on the caller's thread, so _bufs needs
        # no lock here.
        for key, (_meta, slots) in list(self._bufs.items()):
            if slot in slots:
                self._flush(key)
                break
        with self._cv:
            while slot not in self._angles:
                self._cv.wait()
            a = self._angles.pop(slot)
        if isinstance(a, BaseException):
            raise a
        return a
