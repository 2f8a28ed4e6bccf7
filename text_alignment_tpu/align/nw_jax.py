"""Anti-diagonal wavefront NW fill on the JAX default device.

The Gotoh recurrence only depends on diagonals d-1 and d-2, so the fill is a
``lax.scan`` over anti-diagonals with all lanes of a diagonal updated in one
vector step — the device replacement for the reference's O(N·M) Python
loop (textSeqCompare.py:62-88). Pointers for all three matrices are packed
2 bits each into one uint8 per cell, emitted in diagonal layout
``packed[i + j, i]``, and streamed back for the O(N+M) host traceback.

Performance notes:
- no per-step gathers: the OCR lane vector is *carried* through the scan —
  each diagonal shifts it by one and injects the next element via the scan's
  native xs feed; substitution scores come from a lane equality test
  (match/mismatch scoring, the reference's standard case) instead of a
  matrix gather. A substitution-matrix gather path remains for callable
  scoring systems.
- diagonals are processed ``UNROLL`` at a time inside the scan body, which
  amortizes the while-loop per-iteration overhead across 8 diagonals.

Exactness: integer scoring systems run in int32 and match the float64
reference bit-for-bit (all finite scores are small integers; the -2^30
boundary "-inf" can never accumulate into a comparison win because a finite
candidate always exists). Float scoring runs in float32.

Shapes are bucketed to powers of two (min 128) so repeated calls hit the jit
cache; gap parameters and match/mismatch are traced arguments, so e.g. the
evaluation harness's 729-combo grid search reuses one compilation.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .scoring import Scoring, BOUNDARY_GAP_EXTEND

_INT_NEG = -(2**30)
_FLT_NEG = -1e30
_S_PAD = 32
UNROLL = 8
_TB_UNROLL = 8


def _bucket(n: int) -> int:
    """Padding-bucket ladder: powers of two up to 2048 (bounded compile
    set for the chant-page regime), then multiples of 512 — a 2400-char
    stress pair fills at 2560^2 instead of 4096^2 (2.56x fewer cells;
    the pow-2 ladder wasted most of the fill past the knee)."""
    b = 128
    while b < n and b < 2048:
        b *= 2
    if n <= b:
        return b
    return -(-n // 512) * 512


@functools.partial(
    jax.jit, static_argnames=("L", "NoP", "is_int", "use_matrix")
)
def _fill_scan(t_ext, o_feed, S, match, mismatch,
               gox, goy, gex, gey, bge_r0, bge_c0, L, NoP, is_int,
               use_matrix):
    dtype = jnp.int32 if is_int else jnp.float32
    NEG = jnp.asarray(_INT_NEG if is_int else _FLT_NEG, dtype)
    BGE_R0 = bge_r0.astype(dtype)
    BGE_C0 = bge_c0.astype(dtype)

    D = L + NoP - 1
    steps = o_feed.shape[0]  # D padded to a multiple of UNROLL
    lane_i = jnp.arange(L, dtype=jnp.int32)

    goy_gey = (goy + gey).astype(dtype)
    gox_gex = (gox + gex).astype(dtype)
    gex_ = gex.astype(dtype)
    gey_ = gey.astype(dtype)

    def shift_vals(v):
        return jnp.concatenate([jnp.full((1,), NEG, dtype), v[:-1]])

    def shift_in(elem, v):
        return jnp.concatenate([elem[None], v[:-1]])

    def one_diag(carry, d, o_elem):
        m2, x2, y2, m1, x1, y1, o_lane = carry
        o_lane = shift_in(o_elem, o_lane)
        j = d - lane_i

        if use_matrix:
            s = S[t_ext, o_lane].astype(dtype)
        else:
            s = jnp.where(t_ext == o_lane, match, mismatch).astype(dtype)

        m2s, x2s, y2s = shift_vals(m2), shift_vals(x2), shift_vals(y2)
        m1s, x1s, y1s = shift_vals(m1), shift_vals(x1), shift_vals(y1)

        # mat: predecessors at (i-1, j-1) on diagonal d-2
        mc = jnp.stack([m2s, x2s, y2s])
        m_int = jnp.max(mc, axis=0) + s
        mp = jnp.argmax(mc, axis=0).astype(jnp.uint8)

        # y (horizontal gap): predecessors at (i, j-1) on diagonal d-1
        yc = jnp.stack([m1 + goy_gey, x1 + goy_gey, y1 + gey_])
        y_int = jnp.max(yc, axis=0)
        yp = jnp.argmax(yc, axis=0).astype(jnp.uint8)

        # x (vertical gap): predecessors at (i-1, j) on diagonal d-1
        xc = jnp.stack([m1s + gox_gex, x1s + gex_, y1s + gox_gex])
        x_int = jnp.max(xc, axis=0)
        xp = jnp.argmax(xc, axis=0).astype(jnp.uint8)

        # boundary conditions (reference quirks preserved: global -1 gap
        # extend on row/col 0; y[0][j] = -inf including (0,0), x[0][j]
        # finite including (0,0) — textSeqCompare.py:53-60 overwrite order)
        row0 = lane_i == 0
        col0 = (j == 0) & (lane_i > 0)
        invalid = (j < 0) | (j >= NoP)

        jd = j.astype(dtype)
        idd = lane_i.astype(dtype)

        m_v = jnp.where(row0, BGE_R0 * jd,
                        jnp.where(col0, BGE_C0 * idd, m_int))
        x_v = jnp.where(row0, BGE_R0 * jd, jnp.where(col0, NEG, x_int))
        y_v = jnp.where(row0, NEG, jnp.where(col0, BGE_C0 * idd, y_int))

        m_v = jnp.where(invalid, NEG, m_v)
        x_v = jnp.where(invalid, NEG, x_v)
        y_v = jnp.where(invalid, NEG, y_v)

        packed = mp | (xp << 2) | (yp << 4)
        return (m1, x1, y1, m_v, x_v, y_v, o_lane), packed

    def body(carry, xs_step):
        d_base, o_vals = xs_step
        outs = []
        for k in range(UNROLL):
            carry, packed = one_diag(carry, d_base + k, o_vals[k])
            outs.append(packed)
        return carry, jnp.stack(outs)

    init = tuple(jnp.full((L,), NEG, dtype) for _ in range(6)) + (
        jnp.zeros((L,), jnp.int32),
    )
    n_steps = steps // UNROLL
    d_bases = jnp.arange(n_steps, dtype=jnp.int32) * UNROLL
    _, packed = jax.lax.scan(
        body, init, (d_bases, o_feed.reshape(n_steps, UNROLL))
    )
    return packed.reshape(steps, L)[:D]


def _traceback_ops(packed, Nt, No, P):
    """On-device traceback over the packed pointer tensor.

    Replays the reference's pointer walk (textSeqCompare.py:110-145) as a
    ``while_loop``, emitting the op sequence (0 = diagonal, 1 = x-gap,
    2 = y-gap) instead of strings. _TB_UNROLL steps run per iteration
    (inactive steps freeze state; their single dead write lands at the final
    count index, outside the consumed range). Only O(N+M) bytes ever leave
    the device — the O(N·M) pointer tensor never crosses the interconnect.
    """
    cell0 = packed[Nt - 1 + No - 1, Nt - 1]
    mpt0 = (cell0 & 3).astype(jnp.int32)

    def cond(st):
        xpt, ypt, mpt, k, ops = st
        return (xpt > 0) & (ypt > 0)

    def body(st):
        xpt, ypt, mpt, k, ops = st
        for _ in range(_TB_UNROLL):
            active = (xpt > 0) & (ypt > 0)
            ops = ops.at[k].set(mpt.astype(jnp.uint8))
            cell = packed[xpt + ypt, xpt]
            nxt = ((cell >> (2 * mpt)) & 3).astype(jnp.int32)
            dec_x = (mpt != 2) & active
            dec_y = (mpt != 1) & active
            xpt = xpt - dec_x.astype(jnp.int32)
            ypt = ypt - dec_y.astype(jnp.int32)
            mpt = jnp.where(active, nxt, mpt)
            k = k + active.astype(jnp.int32)
        return xpt, ypt, mpt, k, ops

    ops0 = jnp.zeros((P,), jnp.uint8)
    xpt, ypt, mpt, k, ops = jax.lax.while_loop(
        cond, body, (Nt - 1, No - 1, mpt0, jnp.int32(0), ops0)
    )
    return ops.astype(jnp.int32), k, xpt, ypt


def align_jax_ops(transcript, ocr, sc: Scoring):
    """Fused fill + traceback on device. Returns (ops uint8 array, count,
    xpt_final, ypt_final) as numpy/ints — O(N+M) transfer only."""
    Nt, No = len(transcript), len(ocr)
    t_ids, o_ids, S, match, mismatch, is_int, use_matrix = _encode(
        transcript, ocr, sc
    )
    L = _bucket(Nt)
    NoP = _bucket(No)
    D = L + NoP - 1
    steps = ((D + UNROLL - 1) // UNROLL) * UNROLL

    t_ext = np.zeros(L, dtype=np.int32)
    t_ext[1:Nt] = t_ids[: Nt - 1]
    o_feed = np.zeros(steps, dtype=np.int32)
    o_feed[1:No] = o_ids[: No - 1]

    dt = jnp.int32 if is_int else jnp.float32
    ops, k, xpt, ypt = _align_fused(
        jnp.asarray(t_ext),
        jnp.asarray(o_feed),
        jnp.asarray(S),
        jnp.asarray(match, dt),
        jnp.asarray(mismatch, dt),
        jnp.asarray(sc.gap_open_x, dt),
        jnp.asarray(sc.gap_open_y, dt),
        jnp.asarray(sc.gap_extend_x, dt),
        jnp.asarray(sc.gap_extend_y, dt),
        jnp.asarray(sc.bge_row0, dt),
        jnp.asarray(sc.bge_col0, dt),
        jnp.asarray(Nt, jnp.int32),
        jnp.asarray(No, jnp.int32),
        L=L,
        NoP=NoP,
        is_int=is_int,
        use_matrix=use_matrix,
    )
    return np.asarray(ops), int(k), int(xpt), int(ypt)


@functools.partial(
    jax.jit, static_argnames=("L", "NoP", "is_int", "use_matrix")
)
def _align_fused(t_ext, o_feed, S, match, mismatch, gox, goy, gex, gey,
                 bge_r0, bge_c0, Nt, No, L, NoP, is_int, use_matrix):
    packed = _fill_scan(
        t_ext, o_feed, S, match, mismatch, gox, goy, gex, gey,
        bge_r0, bge_c0,
        L=L, NoP=NoP, is_int=is_int, use_matrix=use_matrix,
    )
    return _traceback_ops(packed, Nt, No, P=L + NoP)


def replay_ops(transcript, ocr, ops, count, xpt_tail, ypt_tail):
    """Host replay of the device op sequence into aligned element lists —
    byte-identical to the reference traceback's output
    (textSeqCompare.py:96-170), including the forced sentinel pair and the
    [-1:0:-1] reversal.

    Vectorized: the op stream decodes to exclusive prefix sums of the two
    cursor decrements, so every emitted element is one fancy-indexed
    lookup instead of a Python loop step (the 729-combination grid replays
    ~3.5M steps per sweep — the loop form was a measurable slice of the
    grid wall)."""
    xpt = len(transcript) - 1
    ypt = len(ocr) - 1
    if count > 0:
        o = np.asarray(ops[:count], np.int64)
        dx = o != 2  # op 0 (diag) and 1 (x-gap) consume a transcript char
        dy = o != 1  # op 0 (diag) and 2 (y-gap) consume an OCR char
        cx = np.cumsum(dx)
        cy = np.cumsum(dy)
        xpt_i = xpt - cx + dx  # cursor value BEFORE each step
        ypt_i = ypt - cy + dy
        t_arr = np.array(transcript, dtype=object)
        o_arr = np.array(ocr, dtype=object)
        gap = np.array(["_"], dtype=object)[0]
        tra_mid = np.where(dx, t_arr[xpt_i - 1], gap)
        ocr_mid = np.where(dy, o_arr[ypt_i - 1], gap)
        tra_align = [transcript[xpt]] + list(tra_mid)
        ocr_align = [ocr[ypt]] + list(ocr_mid)
        xpt -= int(cx[-1])
        ypt -= int(cy[-1])
    else:
        tra_align = [transcript[xpt]]
        ocr_align = [ocr[ypt]]
    assert xpt == xpt_tail and ypt == ypt_tail

    if ypt > 0:
        tra_align.extend(["_"] * ypt)
        ocr_align.extend(ocr[ypt - 1 :: -1])
        ypt = 0
    if xpt > 0:
        ocr_align.extend(["_"] * xpt)
        tra_align.extend(transcript[xpt - 1 :: -1])
        xpt = 0

    return tra_align[-1:0:-1], ocr_align[-1:0:-1]


@functools.partial(jax.jit, static_argnames=("L", "NoP", "is_int"))
def _align_fused_grid(t_ext, o_feed, params6, Nt, No, L, NoP, is_int):
    """vmap of the fused fill+traceback over a (P, 6) scoring-parameter
    batch [match, mismatch, gox, goy, gex, gey] — the whole 729-combination
    grid search (evaluate_text_alignment.py:181-189) becomes one device
    dispatch with P wavefronts advancing in lockstep."""
    S = jnp.zeros((1, 1), jnp.int32)

    BGE = jnp.asarray(BOUNDARY_GAP_EXTEND, jnp.int32)

    def one(p):
        match, mismatch, gox, goy, gex, gey = p
        packed = _fill_scan(
            t_ext, o_feed, S, match, mismatch, gox, goy, gex, gey,
            BGE, BGE,
            L=L, NoP=NoP, is_int=is_int, use_matrix=False,
        )
        return _traceback_ops(packed, Nt, No, P=L + NoP)

    ops, k, xpt, ypt = jax.vmap(one)(params6)
    return ops.astype(jnp.int32), k, xpt, ypt


@functools.lru_cache(maxsize=None)
def _sharded_grid_fn(mesh, L, NoP):
    """_align_fused_grid with the scoring-parameter axis sharded over the
    mesh's 'data' axis: each device fills its share of the grid's
    lock-step wavefronts (the 729-combination search fans out like the
    reference's Rodan job queue would; no collectives in the fill)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    def fn(t_ext, o_feed, params6, Nt, No):
        return _align_fused_grid(t_ext, o_feed, params6, Nt, No,
                                 L=L, NoP=NoP, is_int=True)

    return jax.jit(fn, in_shardings=(repl, repl, data, repl, repl),
                   out_shardings=data)


def align_grid_jax(transcript, ocr, params_list, chunk: int = 128,
                   mesh=None):
    """Batched alignment of one (transcript, ocr) pair under many integer
    scoring systems. Returns a list of (tra_align, ocr_align) per params row.

    ``transcript``/``ocr`` exclude the sentinel (it is appended here, like
    perform_alignment does). ``mesh`` shards each chunk's parameter axis
    over the mesh's 'data' axis (rows padded to the axis size by
    replicating row 0; results discarded) — bit-identical to the
    single-device grid (tested)."""
    transcript = list(transcript) + [" "]
    ocr = list(ocr) + [" "]
    Nt, No = len(transcript), len(ocr)

    vocab = sorted(set(transcript) | set(ocr))
    ids = {v: k for k, v in enumerate(vocab)}
    t_ids = np.array([ids[c] for c in transcript], np.int32)
    o_ids = np.array([ids[c] for c in ocr], np.int32)

    L = _bucket(Nt)
    NoP = _bucket(No)
    D = L + NoP - 1
    steps = ((D + UNROLL - 1) // UNROLL) * UNROLL

    t_ext = np.zeros(L, np.int32)
    t_ext[1:Nt] = t_ids[: Nt - 1]
    o_feed = np.zeros(steps, np.int32)
    o_feed[1:No] = o_ids[: No - 1]

    params = np.asarray(params_list, np.int32)
    assert params.shape[1] == 6

    results = []
    for c0 in range(0, len(params), chunk):
        pc = params[c0 : c0 + chunk]
        P_real = len(pc)
        if mesh is not None:
            n_dev = mesh.shape["data"]
            Pp = ((P_real + n_dev - 1) // n_dev) * n_dev
            if Pp != P_real:
                pc = np.concatenate(
                    [pc, np.repeat(pc[:1], Pp - P_real, axis=0)], axis=0)
            from jax.sharding import NamedSharding, PartitionSpec as _P

            from ..parallel.multihost import put_global

            fn = _sharded_grid_fn(mesh, L, NoP)
            ops, k, xpt, ypt = fn(
                t_ext, o_feed,
                put_global(pc, NamedSharding(mesh, _P("data"))),
                np.int32(Nt), np.int32(No),
            )
        else:
            ops, k, xpt, ypt = _align_fused_grid(
                jnp.asarray(t_ext),
                jnp.asarray(o_feed),
                jnp.asarray(pc),
                jnp.asarray(Nt, jnp.int32),
                jnp.asarray(No, jnp.int32),
                L=L,
                NoP=NoP,
                is_int=True,
            )
        from ..parallel.multihost import fetch

        ops, k = fetch(ops)[:P_real], fetch(k)[:P_real]
        xpt, ypt = fetch(xpt)[:P_real], fetch(ypt)[:P_real]
        for b in range(P_real):
            results.append(
                replay_ops(transcript, ocr, ops[b], int(k[b]), int(xpt[b]),
                           int(ypt[b]))
            )
    return results


@functools.partial(jax.jit, static_argnames=("L", "NoP", "is_int"))
def _align_fused_pairs(t_exts, o_feeds, Nts, Nos, match, mismatch,
                       gox, goy, gex, gey, bge_r0, bge_c0, L, NoP, is_int):
    """vmap of the fused fill+traceback over a batch of sequence pairs
    sharing one (L, NoP) bucket and one scoring system — the folio-batch
    path: every page's alignment advances in lockstep on one dispatch."""
    S = jnp.zeros((1, 1), jnp.int32)

    def one(t_ext, o_feed, Nt, No):
        packed = _fill_scan(
            t_ext, o_feed, S, match, mismatch, gox, goy, gex, gey,
            bge_r0, bge_c0,
            L=L, NoP=NoP, is_int=is_int, use_matrix=False,
        )
        return _traceback_ops(packed, Nt, No, P=L + NoP)

    ops, k, xpt, ypt = jax.vmap(one)(t_exts, o_feeds, Nts, Nos)
    return ops.astype(jnp.int32), k, xpt, ypt


@functools.lru_cache(maxsize=None)
def _sharded_pairs_fn(mesh, L, NoP):
    """_align_fused_pairs jitted with the pair-batch axis sharded over the
    mesh's 'data' axis — each device fills its shard of the bucket's
    alignments (the multi-chip NW fan-out; no collectives in the fill)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    def fn(t_exts, o_feeds, Nts, Nos, match, mismatch, gox, goy, gex, gey,
           bge_r0, bge_c0):
        return _align_fused_pairs(
            t_exts, o_feeds, Nts, Nos, match, mismatch, gox, goy, gex, gey,
            bge_r0, bge_c0, L=L, NoP=NoP, is_int=True,
        )

    return jax.jit(fn, in_shardings=(data, data, data, data) + (repl,) * 8,
                   out_shardings=data)


def align_pairs_jax(pairs, sc: Scoring, min_device_cells: int | None = None,
                    mesh=None):
    """Batched alignment of many (transcript, ocr) pairs under one integer
    match/mismatch scoring system. Pairs below ``min_device_cells`` (default:
    the api auto cutoff) run on the native host fill; the rest are grouped
    by their padded (L, NoP) bucket, one device dispatch per group. Returns
    a list of (tra_align, ocr_align) in input order. Sentinels are appended
    here."""
    if sc.match_mismatch is None or not sc.is_integral:
        return [
            None  # caller falls back per pair
            for _ in pairs
        ]
    match, mismatch = (int(v) for v in sc.match_mismatch)

    prepared = []
    for t, o in pairs:
        t = list(t) + [" "]
        o = list(o) + [" "]
        vocab = sorted(set(t) | set(o))
        ids = {v: k for k, v in enumerate(vocab)}
        prepared.append(
            (t, o,
             np.array([ids[c] for c in t], np.int32),
             np.array([ids[c] for c in o], np.int32))
        )

    results = [None] * len(pairs)

    # small pairs are faster on the native host fill than a device
    # dispatch and download; route them out before bucketing so typical
    # chant pages never touch the device
    from .api import auto_device_min_cells
    from .nw_host import fill_host
    from .traceback import DensePtrView, traceback as _traceback

    min_cells = (auto_device_min_cells() if min_device_cells is None
                 else min_device_cells)
    small = [i for i, (t, o, _, _) in enumerate(prepared)
             if len(t) * len(o) < min_cells]
    for i in small:
        t, o, _, _ = prepared[i]
        ptrs = DensePtrView(*fill_host(t, o, sc))
        results[i] = _traceback(t, o, ptrs)

    groups: dict[tuple[int, int], list[int]] = {}
    for i, (t, o, _, _) in enumerate(prepared):
        if results[i] is None:
            groups.setdefault(
                (_bucket(len(t)), _bucket(len(o))), []).append(i)

    dt = jnp.int32
    for (L, NoP), members in sorted(groups.items()):
        D = L + NoP - 1
        steps = ((D + UNROLL - 1) // UNROLL) * UNROLL
        B = len(members)
        t_exts = np.zeros((B, L), np.int32)
        o_feeds = np.zeros((B, steps), np.int32)
        Nts = np.zeros(B, np.int32)
        Nos = np.zeros(B, np.int32)
        for bi, i in enumerate(members):
            t, o, t_ids, o_ids = prepared[i]
            Nt, No = len(t), len(o)
            t_exts[bi, 1:Nt] = t_ids[: Nt - 1]
            o_feeds[bi, 1:No] = o_ids[: No - 1]
            Nts[bi], Nos[bi] = Nt, No

        if mesh is not None:
            # shard the pair batch over the mesh's data axis; pad to a
            # multiple of the axis size by replicating row 0 (valid data,
            # results discarded)
            n_dev = mesh.shape["data"]
            Bp = ((B + n_dev - 1) // n_dev) * n_dev
            if Bp != B:
                padr = lambda a: np.concatenate(
                    [a, np.repeat(a[:1], Bp - B, axis=0)], axis=0
                )
                t_exts, o_feeds = padr(t_exts), padr(o_feeds)
                Nts, Nos = padr(Nts), padr(Nos)
            from jax.sharding import NamedSharding, PartitionSpec as _P

            from ..parallel.multihost import fetch, put_global

            _data = NamedSharding(mesh, _P("data", None))
            _data1 = NamedSharding(mesh, _P("data"))
            fn = _sharded_pairs_fn(mesh, L, NoP)
            ops, k, xpt, ypt = fn(
                put_global(t_exts, _data), put_global(o_feeds, _data),
                put_global(Nts, _data1), put_global(Nos, _data1),
                np.int32(match), np.int32(mismatch),
                np.int32(sc.gap_open_x), np.int32(sc.gap_open_y),
                np.int32(sc.gap_extend_x), np.int32(sc.gap_extend_y),
                np.int32(sc.bge_row0), np.int32(sc.bge_col0),
            )
            ops, k = fetch(ops)[:B], fetch(k)[:B]
            xpt, ypt = fetch(xpt)[:B], fetch(ypt)[:B]
        else:
            ops, k, xpt, ypt = _align_fused_pairs(
                jnp.asarray(t_exts), jnp.asarray(o_feeds),
                jnp.asarray(Nts), jnp.asarray(Nos),
                jnp.asarray(match, dt), jnp.asarray(mismatch, dt),
                jnp.asarray(sc.gap_open_x, dt),
                jnp.asarray(sc.gap_open_y, dt),
                jnp.asarray(sc.gap_extend_x, dt),
                jnp.asarray(sc.gap_extend_y, dt),
                jnp.asarray(sc.bge_row0, dt),
                jnp.asarray(sc.bge_col0, dt),
                L=L, NoP=NoP, is_int=True,
            )
            ops, k = np.asarray(ops), np.asarray(k)
            xpt, ypt = np.asarray(xpt), np.asarray(ypt)
        for bi, i in enumerate(members):
            t, o, _, _ = prepared[i]
            results[i] = replay_ops(
                t, o, ops[bi], int(k[bi]), int(xpt[bi]), int(ypt[bi])
            )
    return results


def _encode(transcript, ocr, sc: Scoring):
    """Map elements to ids; materialize a substitution matrix only for
    callable scoring systems."""
    vocab = sorted(set(transcript) | set(ocr))
    ids = {v: k for k, v in enumerate(vocab)}
    A = len(vocab)

    is_int = sc.is_integral
    if sc.match_mismatch is not None:
        S = np.zeros((_S_PAD, _S_PAD), np.int32)  # unused placeholder
        use_matrix = False
        match, mismatch = sc.match_mismatch
    else:
        Ap = ((A + _S_PAD - 1) // _S_PAD) * _S_PAD
        S = np.zeros((Ap, Ap))
        for a, va in enumerate(vocab):
            for b, vb in enumerate(vocab):
                S[a, b] = sc.score(va, vb)
        is_int = is_int and np.all(S == np.round(S))
        use_matrix = True
        match = mismatch = 0
    S = S.astype(np.int32 if is_int else np.float32)

    t_ids = np.array([ids[c] for c in transcript], dtype=np.int32)
    o_ids = np.array([ids[c] for c in ocr], dtype=np.int32)
    return t_ids, o_ids, S, float(match), float(mismatch), is_int, use_matrix


def fill_jax_packed(transcript, ocr, sc: Scoring):
    """Fill the DP matrices on device; return packed pointers in diagonal
    layout (numpy uint8, shape (L + NoP - 1, L)) for ``DiagPtrView``.

    ``transcript`` / ``ocr`` include the appended sentinel; matrix dims are
    (Nt, No) = (len(transcript), len(ocr)).
    """
    Nt, No = len(transcript), len(ocr)
    t_ids, o_ids, S, match, mismatch, is_int, use_matrix = _encode(
        transcript, ocr, sc
    )

    L = _bucket(Nt)        # lanes cover i = 0..Nt-1 (t index i-1)
    NoP = _bucket(No)
    D = L + NoP - 1
    steps = ((D + UNROLL - 1) // UNROLL) * UNROLL

    t_ext = np.zeros(L, dtype=np.int32)
    t_ext[1:Nt] = t_ids[: Nt - 1]

    # o_feed[d] = element entering the carried OCR lane at diagonal d,
    # i.e. o[j-1] for j = d (lane 0 of diagonal d)
    o_feed = np.zeros(steps, dtype=np.int32)
    o_feed[1:No] = o_ids[: No - 1]

    dt = jnp.int32 if is_int else jnp.float32
    packed = _fill_scan(
        jnp.asarray(t_ext),
        jnp.asarray(o_feed),
        jnp.asarray(S),
        jnp.asarray(match, dt),
        jnp.asarray(mismatch, dt),
        jnp.asarray(sc.gap_open_x, dt),
        jnp.asarray(sc.gap_open_y, dt),
        jnp.asarray(sc.gap_extend_x, dt),
        jnp.asarray(sc.gap_extend_y, dt),
        jnp.asarray(sc.bge_row0, dt),
        jnp.asarray(sc.bge_col0, dt),
        L=L,
        NoP=NoP,
        is_int=is_int,
        use_matrix=use_matrix,
    )
    return np.asarray(jax.device_get(packed))
