"""Batched on-device line normalization (the device version of lineest.py).

The scipy ``CenterNormalizer`` (lineest.py, mirroring ocrolib — the
normalization baked into every trained ``.pyrnn`` model) runs line by line
on one host core; at folio scale it dominates the OCR stage. This module
runs the whole batch on the accelerator so normalized frames are produced
*on device* and flow straight into the BiLSTM without any host round-trip:

- axis-0 Gaussian (sigma = h/2) as a per-strip masked kernel matrix
  (einsum over a (B, Hp, Hp) bank — Hp is small);
- axis-1 Gaussian (sigma = h) as a per-strip 1-D FFT product, the
  center-smoothing Gaussian (sigma = 0.3 h) as a grouped
  ``conv_general_dilated`` (zero padding == scipy's constant mode);
- uniform filters as banded matmuls (rows) and a blocked-matmul prefix
  sum with shift-based window edges (columns) — exact same windows as
  scipy's ``uniform_filter1d`` incl. the int() size cast and size//2
  left origin, no gathers;
- MAD as an exact integer sum (deltas are integers; float64 division
  happens once), matching scipy's float64 mean semantics;
- dewarp + bilinear zoom fused into a single gather from the padded
  strip: out[u, t] = bilerp(grey, center[x] - r + v(u), x(t)) with
  scipy zoom's (in-1)/(out-1) coordinate map and round() output width.

Numerics: float32 with HIGHEST matmul precision. Frames match the scipy
path to ~1e-5 (summation-order differences only); CTC decode output is
identical on all tested fixtures (decode is argmax-based). Strict
bit-for-scipy runs keep the host path (recognizer strict mode).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .lineest import DEFAULT_TARGET_HEIGHT, DEFAULT_PAD

_RANGE = 4
_SMOOTHNESS = 1.0
_EXTRA = 0.3
_TRUNCATE = 4.0


# every matmul asks for full f32: the center-finding chain ends in argmax
# and int casts whose knife edges a reduced-precision product (TF32, bf16
# passes) would flip
_HI = jax.lax.Precision.HIGHEST


def _gauss_kernel_bank(sigma, kmax: int):
    """(B, kmax) gaussian taps, zero beyond each strip's radius
    int(truncate*sigma + 0.5), normalized over the full kernel (scipy
    normalizes by the kernel sum, not the in-bounds sum)."""
    r = kmax // 2
    t = jnp.arange(-r, r + 1, dtype=jnp.float32)[None, :]  # (1, kmax)
    sigma = jnp.maximum(sigma[:, None], 1e-6)
    radius = jnp.floor(_TRUNCATE * sigma + 0.5).astype(jnp.int32)
    w = jnp.exp(-0.5 * (t / sigma) ** 2)
    w = jnp.where(jnp.abs(t) <= radius.astype(jnp.float32), w, 0.0)
    return w / jnp.sum(w, axis=1, keepdims=True)


def _conv_rows(x, kernels):
    """Per-strip 1-D filter along the last axis with zero padding.

    x: (B, R, W); kernels: (B, K) with K odd and SYMMETRIC (gaussian
    banks — both callers), so correlation == convolution. Returns
    (B, R, W) where out[b, i, p] = sum_t kernels[b, t] *
    x_padded[b, i, p + t - K//2].

    Computed as one zero-padded FFT product: the taps run to ~800, and
    the FFT beat a grouped direct conv inside the whole normalizer at
    both the per-folio and the cross-folio sweep shape (CHANGES.md).
    """
    B, R, W = x.shape
    K = kernels.shape[1]
    L = W + K - 1
    Lp = 1 << (L - 1).bit_length()
    X = jnp.fft.rfft(x, n=Lp, axis=2)
    Kf = jnp.fft.rfft(kernels[:, ::-1], n=Lp, axis=1)
    y = jnp.fft.irfft(X * Kf[:, None, :], n=Lp, axis=2)
    return y[:, :, K - 1 - K // 2 : K - 1 - K // 2 + W]


def _windowed_mean_h(x, size):
    """scipy uniform_filter1d semantics along axis 1 (rows): window of
    ``size`` (traced int32 per strip) starting at i - size//2, zero padded
    (constant mode), divided by size. x: (B, H, W); size: (B,).

    H is small (the padded strip height), so the windowed sum is one
    banded per-strip (H, H) matmul."""
    B, H, W = x.shape
    idx = jnp.arange(H, dtype=jnp.int32)
    s = jnp.maximum(size, 1)                       # (B,)
    lo = idx[None, :] - s[:, None] // 2            # (B, H) first tap
    hi = lo + s[:, None] - 1                       # last tap
    j = idx[None, None, :]
    band = ((j >= lo[:, :, None]) & (j <= hi[:, :, None])).astype(jnp.float32)
    summed = jnp.einsum("bij,bjx->bix", band, x, precision=_HI)
    return summed / s[:, None, None].astype(jnp.float32)


def _windowed_mean_w(x, size):
    """scipy uniform_filter1d semantics along axis 2 (columns), same
    contract as :func:`_windowed_mean_h` for per-strip window ``size``.

    W is large, so the inclusive prefix sum runs as a blocked lower-
    triangular matmul (in-block matmul, tiny cross-block cumsum) and the
    two window-edge lookups — which sit at a constant per-strip offset
    from the output index — are per-strip shifts of the prefix array,
    with the right end clamped to the row total and the left end zero.

    The input is centered per row before the prefix sum (mean subtracted,
    added back as n_in * mu with the exact in-range tap count): the
    difference-of-prefix-sums form otherwise cancels catastrophically in
    fp32 at large column positions, which flips the downstream center
    argmax at int-truncation knife edges (this term feeds sm + 0.001 * u)."""
    B, H, W = x.shape
    s = jnp.maximum(size, 1)                       # (B,)
    mu = jnp.mean(x, axis=2, keepdims=True)        # (B, H, 1)
    x = x - mu

    bs = 128
    nb = -(-W // bs)
    Wb = nb * bs
    xp = jnp.pad(x, ((0, 0), (0, 0), (0, Wb - W))) if Wb != W else x
    tri = jnp.tril(jnp.ones((bs, bs), jnp.float32))  # [i, j] = 1 for j <= i
    xb = xp.reshape(B, H, nb, bs)
    intra = jnp.einsum("bhnj,ij->bhni", xb, tri, precision=_HI)
    totals = intra[..., -1]                         # (B, H, nb)
    offs = jnp.cumsum(totals, axis=-1) - totals     # exclusive block offsets
    S = (intra + offs[..., None]).reshape(B, H, Wb)[..., :W]

    # window edges: sum[x] = S[min(x + c1, W-1)] - (x >= c2 ? S[x - c2] : 0).
    # Per-strip shifts of S — computed as traced-amount rolls whose wrapped
    # regions are overwritten by the clamp/zero selects (exact), instead of
    # materializing two (B, H, 2W) concat tensors for dynamic slices
    c1 = s - 1 - s // 2
    c2 = s // 2 + 1
    x_idx = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    last = S[..., W - 1][..., None]
    roll_hi = jax.vmap(lambda row, c: jnp.roll(row, -c, axis=1))(S, c1)
    hi_v = jnp.where(x_idx + c1[:, None, None] <= W - 1, roll_hi, last)
    roll_lo = jax.vmap(lambda row, c: jnp.roll(row, c, axis=1))(S, c2)
    lo_v = jnp.where(x_idx >= c2[:, None, None], roll_lo, 0.0)
    # exact count of in-range taps for the centering correction: the window
    # [x - s//2, x + c1] clipped to [0, W-1] (zero pad contributes no mu)
    n_in = (jnp.minimum(x_idx + c1[:, None, None], W - 1)
            - jnp.maximum(x_idx - (s // 2)[:, None, None], 0) + 1
            ).astype(jnp.float32)
    return (hi_v - lo_v + n_in * mu) / s[:, None, None].astype(jnp.float32)


def _dewarp_zoom(grey, mx, center, r, hs, ws, blank, onebit,
                 target_height, pad, t_max):
    """Dewarp + bilinear zoom + prepare_line from a computed (center, r)."""
    B, Hp, Wp = grey.shape
    i_idx = jnp.arange(Hp, dtype=jnp.int32)
    x_idx = jnp.arange(Wp, dtype=jnp.int32)
    NEG = jnp.float32(-1e30)

    # -- dewarp + zoom fused gather --
    # dewarped[v, x] = padded(grey)[center[x] - r + v, x], v in [0, 2r);
    # zoom scale 48 / 2r; out width t_raw = round(w * 48 / 2r)
    hd = (2 * r).astype(jnp.float32)
    scale = target_height / hd
    t_raw = jnp.round(ws.astype(jnp.float32) * scale).astype(jnp.int32)
    t_cap = t_max - 2 * pad
    t_raw = jnp.clip(t_raw, 0, t_cap)
    t_raw = jnp.where(blank, 0, t_raw)

    # The dewarp+zoom as matmuls instead of ~25M 2-D gathers:
    #   1. circular-roll every column by s[x] = center[x] - r (7 masked
    #      rolls, elementwise) so the dewarp window starts at row 0;
    #   2. row interpolation = one-hot (B, 48, 2Hp) matmul against the
    #      masked/tiled aligned image;
    #   3. column interpolation = one-hot (B, Wp, t_cap) matmul, chunked
    #      over the batch to bound the one-hot matrix memory.
    # Bilinear weights factor exactly across the two matmuls; only float
    # summation order differs from the 4-corner gather formulation.
    J = 2 * Hp
    s = center - r[:, None]                      # (B, Wp) window start
    t_mod = jnp.mod(s, Hp)
    # the roll ladder + tile + mask chain is pure memory traffic (log2(Hp)
    # full-tensor rewrites); on the onebit path every value is exactly
    # 0/1, so the whole chain runs in uint8 (4x less traffic) and the
    # convert back to f32 fuses into the row-interp matmul's operand
    # read — values identical
    aligned = grey.astype(jnp.uint8) if onebit else grey
    k = 1
    while k < Hp:
        bit = (t_mod & k) != 0
        aligned = jnp.where(bit[:, None, :], jnp.roll(aligned, -k, axis=1),
                            aligned)
        k *= 2
    # aligned[j, x] = grey[(j + s[x]) mod Hp, x]; tile to cover j < 2Hp
    tiled = jnp.concatenate([aligned, aligned], axis=1)  # (B, J, Wp)
    j_idx = jnp.arange(J, dtype=jnp.int32)
    true_row = j_idx[None, :, None] + s[:, None, :]      # (B, J, Wp)
    inb = (
        (true_row >= 0)
        & (true_row < hs[:, None, None])
        & (x_idx[None, None, :] < ws[:, None, None])
    )
    if onebit:
        masked = jnp.where(inb, tiled,
                           mx.astype(jnp.uint8)[:, None, None]
                           ).astype(jnp.float32)
    else:
        masked = jnp.where(inb, tiled, mx[:, None, None])

    # row-interp one-hot bank (scipy zoom coords: u * (in-1)/(out-1))
    u_idx = jnp.arange(target_height, dtype=jnp.float32)
    in_h = (2 * r).astype(jnp.float32)
    src_v = u_idx[None, :] * (in_h[:, None] - 1) / (target_height - 1)
    v0 = jnp.floor(src_v).astype(jnp.int32)
    fv = src_v - v0.astype(jnp.float32)
    Rv = (j_idx[None, None, :] == v0[..., None]) * (1 - fv[..., None]) + (
        j_idx[None, None, :] == (v0 + 1)[..., None]
    ) * fv[..., None]
    out1 = jnp.einsum("buj,bjx->bux", Rv.astype(jnp.float32), masked,
                      precision=_HI)  # (B, 48, Wp)

    # column-interp one-hot bank, chunked over the batch
    t_idx = jnp.arange(t_cap, dtype=jnp.float32)
    denom = jnp.maximum(t_raw - 1, 1).astype(jnp.float32)
    src_x = t_idx[None, :] * (ws - 1).astype(jnp.float32)[:, None] / denom[:, None]
    x0 = jnp.floor(src_x).astype(jnp.int32)
    fx = src_x - x0.astype(jnp.float32)

    def col_chunk(args):
        o1, x0c, fxc = args
        xi = jnp.arange(Wp, dtype=jnp.int32)[None, :, None]
        Cx = (xi == x0c[:, None, :]) * (1 - fxc[:, None, :]) + (
            xi == (x0c + 1)[:, None, :]
        ) * fxc[:, None, :]
        return jnp.einsum("bux,bxt->but", o1, Cx.astype(jnp.float32),
                          precision=_HI)

    CH = min(128, B)
    nch = (B + CH - 1) // CH
    Bp = nch * CH
    pad_b = Bp - B
    o1p = jnp.pad(out1, ((0, pad_b), (0, 0), (0, 0)))
    x0p = jnp.pad(x0, ((0, pad_b), (0, 0)))
    fxp_ = jnp.pad(fx, ((0, pad_b), (0, 0)))
    z = jax.lax.map(
        col_chunk,
        (
            o1p.reshape(nch, CH, target_height, Wp),
            x0p.reshape(nch, CH, t_cap),
            fxp_.reshape(nch, CH, t_cap),
        ),
    ).reshape(Bp, target_height, t_cap)[:B]

    tmask = jnp.arange(t_cap, dtype=jnp.int32)[None, None, :] < t_raw[:, None, None]
    z = jnp.where(tmask, z, 0.0)
    zmax = jnp.max(jnp.where(tmask, z, NEG), axis=(1, 2))
    zmax = jnp.where(t_raw > 0, zmax, 1.0)
    # prepare_line: scale to [0,1] then invert (amax of scaled == 1)
    frames_core = jnp.where(tmask, 1.0 - z / zmax[:, None, None], 0.0)
    frames_core = jnp.swapaxes(frames_core, 1, 2)  # (B, t_cap, 48)
    frames = jnp.zeros((B, t_max, target_height), jnp.float32)
    frames = jax.lax.dynamic_update_slice(
        frames, frames_core, (0, pad, 0)
    )
    lengths = jnp.where(blank | (t_raw == 0), 0, t_raw + 2 * pad)
    return frames, lengths.astype(jnp.int32), t_raw.astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("target_height", "pad", "t_max", "onebit"),
)
def normalize_batch_device(grey, hs, ws, target_height=DEFAULT_TARGET_HEIGHT,
                           pad=DEFAULT_PAD, t_max=4096, onebit=False):
    """Batched CenterNormalizer.measure + normalize + prepare_line.

    grey: (B, Hp, Wp) float32 — or uint8 {0,1} with ``onebit=True`` —
          ink-dark (1/1.0 background), garbage outside each strip's
          (hs[b], ws[b]) region (masked here).
    Returns (frames (B, t_max, target_height) f32, lengths (B,) i32,
    t_raws (B,) i32). lengths = t_raw + 2*pad, 0 for blank strips.

    ``onebit=True`` asserts every valid pixel is exactly 0.0 or 1.0 (the
    recognizer's bit-unpacked production input): the contrast
    normalization collapses to boolean reductions — temp IS the ink mask
    (zeroed, like the general path, for the degenerate all-ink strip
    whose max grey is 0) — replacing two full-image f32 max reductions
    and a division pass. Values identical to the general path on such
    inputs (tested).
    """
    B, Hp, Wp = grey.shape
    i_idx = jnp.arange(Hp, dtype=jnp.int32)
    x_idx = jnp.arange(Wp, dtype=jnp.int32)
    valid = (i_idx[None, :, None] < hs[:, None, None]) & (
        x_idx[None, None, :] < ws[:, None, None]
    )

    NEG = jnp.float32(-1e30)
    if onebit:
        # the onebit path never materializes a float page: grey may arrive
        # as uint8 {0,1} (the recognizer's bit-unpacked input), every
        # full-page intermediate before the matmuls stays 1 byte wide,
        # and the u8->f32 converts fuse into the matmul operand reads
        grey = jnp.where(valid, grey.astype(jnp.uint8), jnp.uint8(1))
        ink_b = valid & (grey == 0)
        any_ink = jnp.any(ink_b, axis=(1, 2))
        any_bg = jnp.any(valid & (grey != 0), axis=(1, 2))
        blank = ~(any_ink & any_bg)
        mx = jnp.where(any_bg, 1.0, 0.0).astype(jnp.float32)  # max grey
        temp = jnp.where(ink_b & any_bg[:, None, None], jnp.uint8(1),
                         jnp.uint8(0))
    else:
        grey = jnp.where(valid, grey, 1.0)
        mx = jnp.max(jnp.where(valid, grey, NEG), axis=(1, 2))  # (B,)
        temp = mx[:, None, None] - grey
        temp = jnp.where(valid, temp, 0.0)
        tmax = jnp.max(temp, axis=(1, 2))
        blank = tmax <= 0.0
        temp = temp / jnp.where(blank, 1.0, tmax)[:, None, None]

    hf = hs.astype(jnp.float32)

    # -- measure --
    # axis-0 gaussian, sigma = 0.5 h: per-strip (Hp, Hp) kernel matrix
    k0max = 2 * int(_TRUNCATE * Hp * 0.5 + 0.5) + 1
    sig0 = 0.5 * hf
    rad0 = jnp.floor(_TRUNCATE * sig0 + 0.5).astype(jnp.int32)
    d0 = i_idx[:, None] - i_idx[None, :]  # (Hp, Hp)
    w0 = jnp.exp(
        -0.5 * (d0[None].astype(jnp.float32) / jnp.maximum(sig0, 1e-6)[:, None, None]) ** 2
    )
    w0 = jnp.where(jnp.abs(d0)[None] <= rad0[:, None, None], w0, 0.0)
    # normalize over the FULL kernel sum (scipy), not just in-matrix taps:
    # taps with |d| <= rad0 outside [0, Hp) exist only if rad0 >= Hp; the
    # full sum is computed analytically over [-rad0, rad0]
    t_full = jnp.arange(-(k0max // 2), k0max // 2 + 1,
                        dtype=jnp.float32)[None, :]
    wfull = jnp.exp(-0.5 * (t_full / jnp.maximum(sig0, 1e-6)[:, None]) ** 2)
    wfull = jnp.where(
        jnp.abs(t_full) <= rad0.astype(jnp.float32)[:, None], wfull, 0.0
    )
    w0 = w0 / jnp.sum(wfull, axis=1)[:, None, None]
    sm = jnp.einsum("bij,bjx->bix", w0, temp.astype(jnp.float32),
                    precision=_HI)

    # axis-1 gaussian, sigma = smoothness * h
    k1max = 2 * int(_TRUNCATE * Hp * _SMOOTHNESS + 0.5) + 1
    k1 = _gauss_kernel_bank(_SMOOTHNESS * hf, k1max)
    sm = _conv_rows(sm, k1)

    # + 0.001 * uniform_filter(sm, (0.5 h, w)); the uniform windows must
    # see zeros outside the strip's true (h, w) region (scipy's array ends
    # there), while our padded computation leaves garbage in the margins
    sm_z = jnp.where(valid, sm, 0.0)
    u = _windowed_mean_h(sm_z, (0.5 * hf).astype(jnp.int32))
    u = _windowed_mean_w(u, ws)
    sm = sm + 0.001 * u

    # argmax over rows (restricted to i < h), first-max wins like numpy
    sm = jnp.where(i_idx[None, :, None] < hs[:, None, None], sm, NEG)
    a = jnp.argmax(sm, axis=1).astype(jnp.float32)  # (B, Wp)
    a = jnp.where(x_idx[None, :] < ws[:, None], a, 0.0)

    # gaussian_filter1d(a, extra * h) with scipy's DEFAULT mode="reflect",
    # then int cast (truncation). Reflect-extend each strip's true [0, w)
    # range by the max radius, correlate VALID, all per strip.
    r2max = int(_TRUNCATE * Hp * _EXTRA + 0.5)
    k2 = _gauss_kernel_bank(_EXTRA * hf, 2 * r2max + 1)
    ext_idx = jnp.arange(-r2max, Wp + r2max, dtype=jnp.int32)

    def reflect_extend(ab, w):
        # scipy 'reflect': (d c b a | a b c d | d c b a), period 2w
        m = jnp.mod(ext_idx, 2 * w)
        m = jnp.where(m < 0, m + 2 * w, m)
        src = jnp.where(m < w, m, 2 * w - 1 - m)
        return ab[jnp.clip(src, 0, Wp - 1)]

    a_ext = jax.vmap(reflect_extend)(a, ws)  # (B, Wp + 2*r2max)
    lhs = a_ext[None, :, :]                   # N=1, C=B
    rhs = k2[:, None, ::-1]
    a_s = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        feature_group_count=B, dimension_numbers=("NCH", "OIH", "NCH"),
        precision=_HI,
    )[0]
    center = a_s.astype(jnp.int32)  # (B, Wp), truncation toward zero

    # mad = float64-exact mean of |i - center[x]| over ink pixels
    deltas = jnp.abs(i_idx[None, :, None] - center[:, None, :])
    ink = (temp != 0) & valid
    dsum = jnp.sum(jnp.where(ink, deltas, 0), axis=(1, 2),
                   dtype=jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)
    dcnt = jnp.sum(ink, axis=(1, 2), dtype=jnp.int32)
    mad = dsum.astype(jnp.float64 if jax.config.jax_enable_x64
                      else jnp.float32) / jnp.maximum(dcnt, 1)
    mad = jnp.where(dcnt > 0, mad, hf / 4.0)
    r = (1.0 + _RANGE * mad).astype(jnp.int32)  # (B,), truncation
    # clamp to Hp: the matmul dewarp below covers 2r <= 2*Hp rows; r > Hp
    # only occurs for degenerate strips (ink scattered to the extreme rows)
    # where the dewarped window is mostly background anyway
    r = jnp.clip(r, 1, Hp)

    return _dewarp_zoom(grey, mx, center, r, hs, ws, blank, onebit,
                        target_height, pad, t_max)
