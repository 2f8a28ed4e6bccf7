"""Run-graph connected components on device — compile-tractable XLA CC.

The framework's first device CC implementation (``ops.device.cc_label``)
propagates labels in the PIXEL domain under a data-dependent
``lax.while_loop`` — correct, but a compile-time pathology at page shape.
This module re-derives connected components with **static shapes and a
fixed operation count**:

1. **Runs, not pixels.** Each row's maximal black runs are extracted with
   two shifted compares + one page cumsum and scattered into fixed-size
   ``(MAX_RUNS,)`` tables ``(y, x0, x1)`` in row-major scan order.
2. **Four edges per run.** A run in row ``y`` is 8-connected to a
   contiguous range of runs in row ``y+1`` (runs are sorted and disjoint).
   Linking every run to only the FIRST and LAST overlapping run in the
   rows above and below provably preserves connectivity: if ``u`` overlaps
   ``v`` but ``v`` is not an extreme neighbor of ``u``, then ``u``'s
   interval covers ``v``'s (±1), so ``u`` is ``v``'s ONLY neighbor in that
   direction and the ``(v, u)`` edge exists instead. The four neighbor
   indices come from vectorized ``searchsorted`` over monotone
   ``y*(W+3)+x`` composite keys — no per-row segmentation needed.
3. **Fixed-trip-count min-label propagation with pointer jumping.**
   ``label[i]`` starts at ``i``; each round hooks the min label across the
   four edges, then pointer-jumps ``label = label[label]`` several times
   (jump-doubling: reachable distance squares per jump). Every operation
   is a ``(MAX_RUNS,)`` gather — there is no data-dependent control flow
   anywhere, so the program compiles like any static graph.
4. **Self-verifying.** At a fixpoint the labels are *provably* the exact
   scan-order component minima (labels are monotonically decreasing, stay
   inside their component, and a fixpoint over the retained edges forces
   label constancy per component — so the value is the component's min run
   index, matching the host oracle's scan-order labeling). The kernel
   returns a ``converged`` flag computed from one extra hook; callers
   treat ``False`` (or a run-table overflow) as "fall back to the host
   raster for this page", so a pathological input can never produce
   silently wrong labels.

Reference semantics being implemented: Gamera ``cc_analysis`` /
``despeckle`` (8-connected), SURVEY.md §2.9; call sites
textAlignPreprocessing.py:166-178, 229-239.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

MAX_RUNS = 1 << 17  # fixed run-table size; overflow -> host fallback
# label-propagation budget: HOOKS rounds of (scatter-min hooking onto
# roots + JUMPS path-compression jumps). On the contracted graph every
# non-minimal star hooks to a strictly smaller neighboring star each
# round, so component count at least halves per (compressed) round —
# log2(MAX_RUNS) = 17 rounds suffice; the extra rounds absorb partial
# compression. The `converged` flag is the safety net regardless.
HOOKS = 24
JUMPS = 4


class RunSet(NamedTuple):
    """Fixed-size run table in row-major scan order. Rows >= n are
    invalid padding."""

    y: jax.Array    # (R,) int32 row of each run
    x0: jax.Array   # (R,) int32 first column (inclusive)
    x1: jax.Array   # (R,) int32 last column (inclusive)
    n: jax.Array    # () int32 number of valid runs
    overflow: jax.Array  # () bool — true when the page had > R runs


def extract_runs(img: jax.Array, max_runs: int = MAX_RUNS) -> RunSet:
    """Maximal horizontal black runs of a bool (H, W) page, scan order."""
    H, W = img.shape
    R = max_runs
    left = jnp.pad(img[:, :-1], ((0, 0), (1, 0)))
    right = jnp.pad(img[:, 1:], ((0, 0), (0, 1)))
    start = img & ~left
    end = img & ~right

    sid = jnp.cumsum(start.reshape(-1).astype(jnp.int32)) - 1  # id at starts
    eid = jnp.cumsum(end.reshape(-1).astype(jnp.int32)) - 1
    n = sid[-1] + 1
    xs = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (H, W))
    ys = jnp.broadcast_to(jnp.arange(H, dtype=jnp.int32)[:, None], (H, W))
    sidx = jnp.where(start.reshape(-1), sid, R)  # R = out-of-bounds: drop
    eidx = jnp.where(end.reshape(-1), eid, R)

    x0 = jnp.zeros(R, jnp.int32).at[sidx].set(xs.reshape(-1), mode="drop")
    x1 = jnp.zeros(R, jnp.int32).at[eidx].set(xs.reshape(-1), mode="drop")
    y = jnp.full(R, H, jnp.int32).at[sidx].set(ys.reshape(-1), mode="drop")
    return RunSet(y, x0, x1, jnp.minimum(n, R), n > R)


class RunEdges(NamedTuple):
    """Per-run neighbor indices (self-index where no neighbor exists)."""

    up_lo: jax.Array
    up_hi: jax.Array
    dn_lo: jax.Array
    dn_hi: jax.Array


def run_edges(rs: RunSet, W: int) -> RunEdges:
    """First/last 8-connected neighbor runs in the adjacent rows."""
    R = rs.y.shape[0]
    valid = jnp.arange(R, dtype=jnp.int32) < rs.n
    BIG = jnp.int32(2**31 - 1)
    stride = W + 3
    # x+1 keeps keys nonnegative for x0-1 targets; strictly increasing
    # within a row because runs are disjoint and sorted
    key_x0 = jnp.where(valid, rs.y * stride + rs.x0 + 1, BIG)
    key_x1 = jnp.where(valid, rs.y * stride + rs.x1 + 1, BIG)
    idx = jnp.arange(R, dtype=jnp.int32)

    def _dir(dy):
        ty = rs.y + dy
        # lo: first run j in row ty with x1[j] >= x0 - 1
        lo = jnp.searchsorted(key_x1, ty * stride + rs.x0, side="left")
        lo_c = jnp.minimum(lo, R - 1).astype(jnp.int32)
        lo_ok = (
            valid
            & (lo < rs.n)
            & (rs.y[lo_c] == ty)
            & (rs.x0[lo_c] <= rs.x1 + 1)
        )
        # hi: last run j in row ty with x0[j] <= x1 + 1
        hi = jnp.searchsorted(key_x0, ty * stride + rs.x1 + 2,
                              side="right") - 1
        hi_c = jnp.clip(hi, 0, R - 1).astype(jnp.int32)
        hi_ok = (
            valid
            & (hi >= 0)
            & (rs.y[hi_c] == ty)
            & (rs.x1[hi_c] >= rs.x0 - 1)
        )
        return jnp.where(lo_ok, lo_c, idx), jnp.where(hi_ok, hi_c, idx)

    up_lo, up_hi = _dir(-1)
    dn_lo, dn_hi = _dir(1)
    return RunEdges(up_lo, up_hi, dn_lo, dn_hi)


def label_runs(rs: RunSet, edges: RunEdges,
               hooks: int = HOOKS, jumps: int = JUMPS):
    """Shiloach–Vishkin-style union over the run graph. Returns
    (labels, converged): at a fixpoint each run's label is its component's
    minimum run index (scan order, matching the oracle's label order).

    Each round scatter-min-hooks every run's *root* onto the smaller of
    its neighbors' parents (both directions of every stored edge), then
    path-compresses with ``P = P[P]`` jumps. Parents only ever decrease
    and always stay inside the component, so the component-minimum run is
    a fixed root and every fixpoint is exact — the converged flag is both
    a convergence and a correctness certificate."""
    R = rs.y.shape[0]
    P = jnp.arange(R, dtype=jnp.int32)
    es = (edges.up_lo, edges.up_hi, edges.dn_lo, edges.dn_hi)
    for _ in range(hooks):
        for e in es:
            pe = P[e]
            # hook i's root toward e[i]'s parent and vice versa — the
            # retained-extreme edges are stored one-directionally, so
            # both scatters are needed for the halving argument
            P = P.at[P].min(pe)
            P = P.at[pe].min(P)
        for _ in range(jumps):
            P = P[P]
    conv = jnp.bool_(True)
    for e in es:
        conv &= jnp.all(P[e] == P)
    return P, conv


class RunCC(NamedTuple):
    """Per-run component stats (indexed by each run's root run id)."""

    lbl: jax.Array        # (R,) int32 root run index per run
    area: jax.Array       # (R,) int32 component area at root slots
    rmin: jax.Array       # (R,) int32 component min row at root slots
    rmax: jax.Array
    cmin: jax.Array
    cmax: jax.Array
    converged: jax.Array  # () bool
    overflow: jax.Array   # () bool


def run_cc(rs: RunSet, W: int, hooks: int = HOOKS, jumps: int = JUMPS) -> RunCC:
    """Label + per-component stats in one pass."""
    R = rs.y.shape[0]
    H_sentinel = jnp.int32(2**30)
    edges = run_edges(rs, W)
    lbl, conv = label_runs(rs, edges, hooks, jumps)
    valid = jnp.arange(R, dtype=jnp.int32) < rs.n
    idx = jnp.where(valid, lbl, R)  # R = drop
    length = rs.x1 - rs.x0 + 1
    area = jnp.zeros(R, jnp.int32).at[idx].add(
        jnp.where(valid, length, 0), mode="drop")
    rmin = jnp.full(R, H_sentinel, jnp.int32).at[idx].min(rs.y, mode="drop")
    rmax = jnp.full(R, -1, jnp.int32).at[idx].max(
        jnp.where(valid, rs.y, -1), mode="drop")
    cmin = jnp.full(R, H_sentinel, jnp.int32).at[idx].min(rs.x0, mode="drop")
    cmax = jnp.full(R, -1, jnp.int32).at[idx].max(
        jnp.where(valid, rs.x1, -1), mode="drop")
    return RunCC(lbl, area, rmin, rmax, cmin, cmax, conv, rs.overflow)


def paint_runs(rs: RunSet, keep: jax.Array, H: int, W: int) -> jax.Array:
    """Bool (H, W) page with the kept runs painted black (interval
    scatter + row cumsum — no per-run loops)."""
    R = rs.y.shape[0]
    valid = (jnp.arange(R, dtype=jnp.int32) < rs.n) & keep
    Wp = W + 1
    p0 = jnp.where(valid, rs.y * Wp + rs.x0, H * Wp)
    p1 = jnp.where(valid, rs.y * Wp + rs.x1 + 1, H * Wp)
    delta = jnp.zeros(H * Wp, jnp.int32)
    delta = delta.at[p0].add(1, mode="drop").at[p1].add(-1, mode="drop")
    return jnp.cumsum(delta.reshape(H, Wp), axis=1)[:, :W] > 0


def _flags(ok, cc: RunCC):
    return ok & cc.converged & ~cc.overflow


def despeckle(img: jax.Array, k, max_runs: int = MAX_RUNS):
    """Gamera despeckle(k): remove black CCs with area <= k. Returns
    (page, ok); ok=False means host fallback required (unconverged or run
    overflow — never silently wrong)."""
    H, W = img.shape
    rs = extract_runs(img, max_runs)
    cc = run_cc(rs, W)
    keep = cc.area[cc.lbl] > k
    return paint_runs(rs, keep, H, W), _flags(jnp.bool_(True), cc)


def despeckle_white(img: jax.Array, k, max_runs: int = MAX_RUNS):
    """``~despeckle(~img, k)``: white CCs with area <= k become black
    (textAlignPreprocessing.py:169-171)."""
    H, W = img.shape
    rs = extract_runs(~img, max_runs)
    cc = run_cc(rs, W)
    small = cc.area[cc.lbl] <= k
    return img | paint_runs(rs, small, H, W), _flags(jnp.bool_(True), cc)


def remove_tall_ccs(img: jax.Array, max_nrows, max_runs: int = MAX_RUNS,
                    by_area: bool = False):
    """fill_white CCs whose ROW COUNT exceeds the threshold — the
    reference's nrows-as-area quirk (textAlignPreprocessing.py:174-178).
    ``by_area=True`` = strict=False corrected mode (true pixel area)."""
    H, W = img.shape
    rs = extract_runs(img, max_runs)
    cc = run_cc(rs, W)
    measure = cc.area if by_area else cc.rmax - cc.rmin + 1
    keep = measure[cc.lbl] <= max_nrows
    return paint_runs(rs, keep, H, W), _flags(jnp.bool_(True), cc)


def preproc_clean(img: jax.Array, despeckle_amt, sat_area_thresh,
                  max_runs: int = MAX_RUNS, sat_by_area: bool = False):
    """The binarized-page cleanup chain of preprocess_images
    (textAlignPreprocessing.py:166-178): despeckle black, despeckle white,
    drop tall CCs. Returns (page, ok)."""
    img, ok1 = despeckle(img, despeckle_amt, max_runs)
    img, ok2 = despeckle_white(img, despeckle_amt, max_runs)
    img, ok3 = remove_tall_ccs(img, sat_area_thresh, max_runs,
                               by_area=sat_by_area)
    return img, ok1 & ok2 & ok3


def cc_table_compact(img: jax.Array, min_area_keep=None,
                     max_ccs: int = 4096, max_runs: int = MAX_RUNS):
    """Compact per-CC stats table in scan order — the run-graph equivalent
    of ``device.cc_stats_compact``. Returns (table (max_ccs, 5) int32 with
    columns (uly, lry, ulx, lrx, area), count, ok). ``min_area_keep``
    optionally drops components with area <= it on device (the caller's
    noise filter, textAlignPreprocessing.py:229-235), shrinking the
    downloaded table. ok=False -> host fallback (also when count > max_ccs).
    """
    R = max_runs
    H, W = img.shape
    rs = extract_runs(img, max_runs)
    cc = run_cc(rs, W)
    valid = jnp.arange(R, dtype=jnp.int32) < rs.n
    is_root = valid & (cc.lbl == jnp.arange(R, dtype=jnp.int32))
    if min_area_keep is not None:
        is_root &= cc.area > min_area_keep
    slot = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    count = jnp.where(rs.n > 0, slot[-1] + 1, 0)
    sidx = jnp.where(is_root, slot, max_ccs)  # drop-mode scatter
    table = jnp.zeros((max_ccs, 5), jnp.int32)
    cols = jnp.stack([cc.rmin, cc.rmax, cc.cmin, cc.cmax, cc.area], axis=1)
    table = table.at[sidx].set(cols, mode="drop")
    ok = cc.converged & ~cc.overflow & (count <= max_ccs)
    return table, count, ok
