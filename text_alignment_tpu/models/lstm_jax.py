"""Batched JAX BiLSTM+softmax line recognizer (the device OCR engine).

Batched formulation of the recognizer whose semantics are pinned by
:mod:`.lstm_np`: one ``lax.scan`` over time per direction, each step doing a
single fused (B, na) x (na, 4*ns) matmul for all four gates of the whole
batch of lines — the replacement for ocropus-rpred's per-file per-frame
Python loops (SURVEY.md §2.10, alignToOCR.py:128-184).

Variable-length lines are padded to bucketed T; the backward direction uses
a length-aware reversal gather so each line's reversed scan sees exactly its
own frames (padding never contaminates the carry). Float32 throughout,
every product at ``Precision.HIGHEST`` (full f32, never TF32) — the model
is tiny, and CTC decode positions must be stable.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class LSTMParams(NamedTuple):
    WGI: jax.Array  # (ns, na), na = 1 + ni + ns
    WGF: jax.Array
    WGO: jax.Array
    WCI: jax.Array
    WIP: jax.Array  # (ns,)
    WFP: jax.Array
    WOP: jax.Array


class BiLSTMParams(NamedTuple):
    fwd: LSTMParams
    bwd: LSTMParams
    W2: jax.Array  # (nout, 2*ns + 1)


def init_lstm(key, ni: int, ns: int, initial_range: float = 0.1) -> LSTMParams:
    na = 1 + ni + ns
    ks = jax.random.split(key, 7)
    u = lambda k, shape: jax.random.uniform(
        k, shape, jnp.float32, -initial_range, initial_range
    )
    return LSTMParams(
        WGI=u(ks[0], (ns, na)),
        WGF=u(ks[1], (ns, na)),
        WGO=u(ks[2], (ns, na)),
        WCI=u(ks[3], (ns, na)),
        WIP=u(ks[4], (ns,)),
        WFP=u(ks[5], (ns,)),
        WOP=u(ks[6], (ns,)),
    )


def init_bilstm(key, ni: int, ns: int, nout: int,
                initial_range: float = 0.1) -> BiLSTMParams:
    k1, k2, k3 = jax.random.split(key, 3)
    W2 = jax.random.uniform(
        k3, (nout, 2 * ns + 1), jnp.float32, -initial_range, initial_range
    )
    return BiLSTMParams(
        fwd=init_lstm(k1, ni, ns, initial_range),
        bwd=init_lstm(k2, ni, ns, initial_range),
        W2=W2,
    )


# lax.scan unroll of the recurrence: 8 steps per loop iteration amortize
# the per-iteration cost of the GPU while loop (fastest of 1/2/4/8 on the
# forward pass; the timings are in CHANGES.md)
SCAN_UNROLL = 8


def _bidir_scan(Wf: LSTMParams, Wb: LSTMParams, xs_f, xs_b):
    """Both LSTM directions in ONE ``lax.scan``.

    xs_f / xs_b: (B, T, ni) forward frames and length-reversed frames.
    Returns (f, b_rev), each (B, T, ns). One fused gate matmul per step,
    batched over a leading direction axis: the per-step matmuls are tiny,
    so the scan is loop-overhead-bound — stacking the directions halves
    the sequential step count vs one scan per direction. Per-direction
    numerics are unchanged (the direction axis is a batched matmul
    dimension)."""
    B, T, ni = xs_f.shape
    ns = Wf.WGI.shape[0]

    def fuse(W):
        # fused gate weights, split into input / bias / recurrent blocks so
        # the input contribution for all timesteps is one big matmul
        Wg = jnp.concatenate([W.WGI, W.WGF, W.WGO, W.WCI], axis=0)  # (4ns, na)
        return Wg[:, 0], Wg[:, 1 : 1 + ni], Wg[:, 1 + ni :]

    bias_f, Wx_f, Wh_f = fuse(Wf)
    bias_b, Wx_b, Wh_b = fuse(Wb)
    bias = jnp.stack([bias_f, bias_b])   # (2, 4ns)
    Wx = jnp.stack([Wx_f, Wx_b])         # (2, 4ns, ni)
    Wh = jnp.stack([Wh_f, Wh_b])         # (2, 4ns, ns)
    WIP = jnp.stack([Wf.WIP, Wb.WIP])[:, None, :]  # (2, 1, ns)
    WFP = jnp.stack([Wf.WFP, Wb.WFP])[:, None, :]
    WOP = jnp.stack([Wf.WOP, Wb.WOP])[:, None, :]

    # precompute input projections for every frame in one batched matmul
    xs2 = jnp.stack([xs_f, xs_b])        # (2, B, T, ni)
    xproj = (
        jnp.einsum("dbti,dgi->dbtg", xs2, Wx, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
        + bias[:, None, None, :]
    )

    def step(carry, inp):
        out_prev, state_prev, t = carry  # (2, B, ns)
        gates = inp + jnp.einsum(
            "dbs,dgs->dbg", out_prev, Wh, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST
        )
        gix, gfx, gox, cix = jnp.split(gates, 4, axis=2)
        not_first = (t > 0).astype(jnp.float32)
        gix = gix + WIP * state_prev * not_first
        gfx = gfx + WFP * state_prev * not_first
        gi = jax.nn.sigmoid(gix)
        gf = jax.nn.sigmoid(gfx)
        ci = jnp.tanh(cix)
        state = ci * gi + gf * state_prev * not_first
        gox = gox + WOP * state * not_first  # ocropy quirk: skipped at t=0
        go = jax.nn.sigmoid(gox)
        out = jnp.tanh(state) * go
        return (out, state, t + 1), out

    init = (
        jnp.zeros((2, B, ns), jnp.float32),
        jnp.zeros((2, B, ns), jnp.float32),
        jnp.int32(0),
    )
    _, outs = jax.lax.scan(step, init, jnp.moveaxis(xproj, 2, 0),
                           unroll=SCAN_UNROLL)
    outs = jnp.moveaxis(outs, 0, 2)  # (2, B, T, ns)
    return outs[0], outs[1]


def _reverse_by_length(xs, lengths):
    """Per-sequence reversal of the valid prefix: out[b, t] = xs[b, L_b-1-t]
    for t < L_b, else 0."""
    B, T = xs.shape[0], xs.shape[1]
    t_idx = jnp.arange(T, dtype=jnp.int32)[None, :]
    src = lengths[:, None] - 1 - t_idx
    valid = src >= 0
    src_c = jnp.clip(src, 0, T - 1)
    gathered = jnp.take_along_axis(
        xs, src_c[..., None] if xs.ndim == 3 else src_c, axis=1
    )
    mask = valid[..., None] if xs.ndim == 3 else valid
    return jnp.where(mask, gathered, 0)


@jax.jit
def bilstm_forward_batched(params: BiLSTMParams, xs, lengths):
    """xs: (B, T, ni) padded frames; lengths: (B,) int32 valid frame counts.
    Returns (B, T, nout) posteriors (softmax over the full padded T; frames
    past each line's length are meaningless and masked by the decoder)."""
    xs_rev = _reverse_by_length(xs, lengths)
    f, b_rev = _bidir_scan(params.fwd, params.bwd, xs, xs_rev)
    b = _reverse_by_length(b_rev, lengths)
    y = jnp.concatenate([f, b], axis=2)  # (B, T, 2ns)
    ones = jnp.ones(y.shape[:2] + (1,), jnp.float32)
    inputs = jnp.concatenate([ones, y], axis=2)
    logits = jnp.einsum(
        "btk,ok->bto", inputs, params.W2, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST
    )
    logits = jnp.clip(logits, -100, 100)
    e = jnp.exp(logits)
    return e / jnp.sum(e, axis=2, keepdims=True)


def params_from_np(d) -> BiLSTMParams:
    """Build BiLSTMParams from the numpy-dict format of lstm_np / pyrnn."""
    def conv(W):
        return LSTMParams(
            **{k: jnp.asarray(np.asarray(W[k], np.float32)) for k in LSTMParams._fields}
        )

    return BiLSTMParams(
        fwd=conv(d["fwd"]), bwd=conv(d["bwd"]), W2=jnp.asarray(np.asarray(d["W2"], np.float32))
    )


def params_to_np(p: BiLSTMParams):
    return {
        "fwd": {k: np.asarray(v) for k, v in p.fwd._asdict().items()},
        "bwd": {k: np.asarray(v) for k, v in p.bwd._asdict().items()},
        "W2": np.asarray(p.W2),
    }
