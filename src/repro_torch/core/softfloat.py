"""Word-parallel software FP emulation (the SoftFP-style oracle) and the
float32 <-> code codecs of the torch port.

1. **Oracle** for the bitslice circuits: a second, independent
   implementation of the FloPoCo-semantics multiplier/adder, written as
   conventional integer arithmetic over numpy arrays.  The circuit tests
   check gate-level results against these functions exhaustively for
   small formats.  Functions here operate on integer *code words* (see
   :mod:`repro_torch.core.fpformat` for the layout) held in int64 arrays.

2. **Codecs** ``encode_torch`` / ``decode_torch``: float32 <-> int32
   code words as pure integer and bitcast tensor ops, so they run on the
   card as well as on the CPU; ``encode_storage`` / ``decode_storage``
   do the same for the exception-free weight codes of
   :class:`~repro_torch.core.fpformat.StorageFormat`.
"""
from __future__ import annotations

import numpy as np
import torch

from .fpformat import (EXC_INF, EXC_NAN, EXC_NORMAL, EXC_ZERO, RNE, RTZ,
                       FPFormat, StorageFormat)

_GUARD = 3  # guard/round/sticky bits carried through the adder datapath


# ---------------------------------------------------------------------------
# Field access
# ---------------------------------------------------------------------------
def _idt(xp):
    return xp.int64 if xp is np else xp.int32


def unpack(codes, fmt: FPFormat, xp=np):
    codes = xp.asarray(codes).astype(_idt(xp))
    frac = codes & ((1 << fmt.w_f) - 1)
    exp = (codes >> fmt.exp_off) & ((1 << fmt.w_e) - 1)
    sign = (codes >> fmt.sign_off) & 1
    exc = (codes >> fmt.exc_off) & 3
    return exc, sign, exp, frac


def pack(exc, sign, exp, frac, fmt: FPFormat, xp=np):
    exc = xp.asarray(exc).astype(_idt(xp))
    normal = exc == EXC_NORMAL
    # Canonicalize: non-normal values carry zero exp/frac fields.
    exp = xp.where(normal, exp, 0).astype(_idt(xp))
    frac = xp.where(normal, frac, 0).astype(_idt(xp))
    sign = xp.asarray(sign).astype(_idt(xp))
    return (frac | (exp << fmt.exp_off) | (sign << fmt.sign_off)
            | (exc << fmt.exc_off))


# ---------------------------------------------------------------------------
# float64 <-> code conversion (host side, numpy only)
# ---------------------------------------------------------------------------
def encode(x, fmt: FPFormat, rounding: str = RNE) -> np.ndarray:
    """Quantize float64 values into HOBFLOPS code words."""
    x = np.asarray(x, dtype=np.float64)
    out_shape = x.shape
    x = np.atleast_1d(x)

    isnan = np.isnan(x)
    isinf = np.isinf(x)
    sign = (np.signbit(x)).astype(np.int64)
    ax = np.abs(np.where(isnan | isinf, 1.0, x))

    m, e = np.frexp(ax)                 # ax = m * 2^e, m in [0.5, 1)
    sig = m * 2.0                       # [1, 2)
    e = e - 1
    scaled = (sig - 1.0) * float(1 << fmt.w_f)   # exact in f64 for w_f<=40
    if rounding == RNE:
        frac = np.rint(scaled).astype(np.int64)  # rint = half-to-even
    elif rounding == RTZ:
        frac = np.floor(scaled).astype(np.int64)
    else:
        raise ValueError(rounding)
    carry = frac >= (1 << fmt.w_f)
    frac = np.where(carry, 0, frac)
    e = e + carry
    biased = e + fmt.bias

    exc = np.full(x.shape, EXC_NORMAL, dtype=np.int64)
    exc = np.where(biased < 0, EXC_ZERO, exc)           # flush to zero
    exc = np.where(biased > fmt.emax, EXC_INF, exc)     # overflow
    exc = np.where(ax == 0.0, EXC_ZERO, exc)
    exc = np.where(isinf, EXC_INF, exc)
    exc = np.where(isnan, EXC_NAN, exc)
    sign = np.where(isnan, 0, sign)
    # Underflow flush produces +0 (FloPoCo-flavored; the adder/mul
    # datapaths do the same) — true -0.0 inputs keep their sign.
    sign = np.where((biased < 0) & (ax != 0.0), 0, sign)

    biased = np.clip(biased, 0, fmt.emax)
    return pack(exc, sign, biased, frac, fmt).reshape(out_shape)


def decode(codes, fmt: FPFormat) -> np.ndarray:
    codes = np.atleast_1d(np.asarray(codes))
    exc, sign, exp, frac = unpack(codes, fmt)
    sig = 1.0 + frac.astype(np.float64) / float(1 << fmt.w_f)
    val = np.ldexp(sig, (exp - fmt.bias).astype(np.int64))
    val = np.where(sign == 1, -val, val)
    val = np.where(exc == EXC_ZERO, np.where(sign == 1, -0.0, 0.0), val)
    val = np.where(exc == EXC_INF, np.where(sign == 1, -np.inf, np.inf), val)
    val = np.where(exc == EXC_NAN, np.nan, val)
    return val.reshape(np.asarray(codes).shape)


# ---------------------------------------------------------------------------
# Rounding helper: value has `drop` low bits to discard.
# ---------------------------------------------------------------------------
def _round_drop(value, drop: int, rounding: str, xp=np):
    """Round `value` (int64) down by `drop` bits. Returns rounded value."""
    if drop <= 0:
        return value << (-drop)
    kept = value >> drop
    if rounding == RTZ:
        return kept
    rnd = (value >> (drop - 1)) & 1
    if drop >= 2:
        sticky = (value & ((1 << (drop - 1)) - 1)) != 0
    else:
        sticky = xp.zeros_like(value, dtype=bool)
    lsb = kept & 1
    round_up = (rnd == 1) & (sticky | (lsb == 1))
    return kept + round_up.astype(_idt(xp))


# ---------------------------------------------------------------------------
# Multiplier: (fmt_in, fmt_in) -> fmt_out
# ---------------------------------------------------------------------------
def fp_mul(x, y, fmt_in: FPFormat, fmt_out: FPFormat,
           rounding: str = RNE, xp=np):
    """FloPoCo-semantics FP multiply.  fmt_out.w_e must equal fmt_in.w_e."""
    assert fmt_out.w_e == fmt_in.w_e
    wf = fmt_in.w_f
    exc_x, sx, ex, fx = unpack(x, fmt_in, xp)
    exc_y, sy, ey, fy = unpack(y, fmt_in, xp)

    sign = sx ^ sy
    sig_x = fx | (1 << wf)
    sig_y = fy | (1 << wf)
    prod = sig_x * sig_y                      # in [2^(2wf), 2^(2wf+2))
    norm = (prod >> (2 * wf + 1)) & 1         # product >= 2.0
    # Normalized significand 1.f with 2wf+1 fraction bits.
    frac_full = xp.where(norm == 1,
                         prod & ((1 << (2 * wf + 1)) - 1),
                         (prod << 1) & ((1 << (2 * wf + 1)) - 1))
    drop = (2 * wf + 1) - fmt_out.w_f
    frac_r = _round_drop(frac_full, drop, rounding, xp)
    carry = (frac_r >> fmt_out.w_f) & 1       # rounding overflowed to 2.0
    frac_r = xp.where(carry == 1, 0, frac_r) & ((1 << fmt_out.w_f) - 1)

    e_res = ex + ey - fmt_in.bias + norm + carry
    underflow = e_res < 0
    overflow = e_res > fmt_out.emax

    x_nan, y_nan = exc_x == EXC_NAN, exc_y == EXC_NAN
    x_inf, y_inf = exc_x == EXC_INF, exc_y == EXC_INF
    x_zero, y_zero = exc_x == EXC_ZERO, exc_y == EXC_ZERO
    x_norm, y_norm = exc_x == EXC_NORMAL, exc_y == EXC_NORMAL

    nan = x_nan | y_nan | (x_inf & y_zero) | (x_zero & y_inf)
    inf = (~nan) & ((x_inf & (y_inf | y_norm)) | (y_inf & x_norm)
                    | (x_norm & y_norm & overflow))
    zero = (~nan) & (~inf) & ((x_zero & (y_zero | y_norm))
                              | (y_zero & x_norm)
                              | (x_norm & y_norm & underflow))
    exc = xp.where(nan, EXC_NAN,
                   xp.where(inf, EXC_INF,
                            xp.where(zero, EXC_ZERO, EXC_NORMAL)))
    sign = xp.where(nan, 0, sign)
    # underflow-flushed zeros are +0 (zero-operand products keep the
    # IEEE XOR sign)
    sign = xp.where(x_norm & y_norm & underflow & zero, 0, sign)
    e_res = xp.clip(e_res, 0, fmt_out.emax)
    return pack(exc, sign, e_res, frac_r, fmt_out, xp)


# ---------------------------------------------------------------------------
# Adder: (fmt, fmt) -> fmt
# ---------------------------------------------------------------------------
def fp_add(x, y, fmt: FPFormat, rounding: str = RNE, xp=np):
    """FloPoCo-semantics FP add (single datapath, flush-to-zero)."""
    wf, G = fmt.w_f, _GUARD
    W = wf + 1 + G                       # significand width incl guards
    exc_x, sx, ex, fx = unpack(x, fmt, xp)
    exc_y, sy, ey, fy = unpack(y, fmt, xp)

    # Treat non-normal operands as magnitude-0 on the datapath; exception
    # logic overrides the result afterwards.
    x_norm = exc_x == EXC_NORMAL
    y_norm = exc_y == EXC_NORMAL
    mag_x = xp.where(x_norm, (ex << wf) | fx, -1)   # -1 so zeros lose swaps
    mag_y = xp.where(y_norm, (ey << wf) | fy, -1)

    swap = mag_y > mag_x
    s_big = xp.where(swap, sy, sx)
    e_big = xp.where(swap, ey, ex)
    f_big = xp.where(swap, fy, fx)
    e_sml = xp.where(swap, ex, ey)
    f_sml = xp.where(swap, fx, fy)
    big_norm = xp.where(swap, y_norm, x_norm)
    sml_norm = xp.where(swap, x_norm, y_norm)

    sig_big = xp.where(big_norm, (f_big | (1 << wf)) << G, 0)
    sig_sml_full = xp.where(sml_norm, (f_sml | (1 << wf)) << G, 0)
    d = xp.clip(e_big - e_sml, 0, W + 1)
    sig_sml = sig_sml_full >> d
    sticky_in = (sig_sml_full & ((1 << d) - 1)) != 0
    sig_sml = sig_sml | sticky_in.astype(_idt(xp))

    sub = (sx ^ sy) == 1
    mag = xp.where(sub, sig_big - sig_sml, sig_big + sig_sml)  # W+1 bits
    mag_zero = mag == 0

    # Normalize: find leading one position p (bit index), shift so the
    # leading one lands at bit W-1 (i.e. weight 1.0 before the G guards).
    # p == W means carry-out (add case): shift right 1.
    def _lead(m):
        # highest set bit index of m (m > 0); vectorized.
        p = xp.zeros_like(m)
        for b in range(W + 1):
            p = xp.where((m >> b) & 1 == 1, b, p)
        return p

    p = _lead(xp.where(mag_zero, 1, mag))
    shl = (W - 1) - p                    # >0: shift left; -1: shift right
    carry_case = shl < 0
    mag_l = mag << xp.clip(shl, 0, W)
    lost = mag & 1                       # bit lost when shifting right 1
    mag_r = (mag >> 1) | lost            # keep sticky
    mag_n = xp.where(carry_case, mag_r, mag_l)
    e_res = e_big - xp.clip(shl, -1, W)  # e - shl  (+1 in carry case)

    frac_r = _round_drop(mag_n, G, rounding, xp)         # wf+1 bits + carry
    rcarry = (frac_r >> (wf + 1)) & 1
    frac_r = xp.where(rcarry == 1, frac_r >> 1, frac_r)
    e_res = e_res + rcarry
    frac_out = frac_r & ((1 << wf) - 1)

    underflow = e_res < 0
    overflow = e_res > fmt.emax

    x_nan, y_nan = exc_x == EXC_NAN, exc_y == EXC_NAN
    x_inf, y_inf = exc_x == EXC_INF, exc_y == EXC_INF
    x_zero, y_zero = exc_x == EXC_ZERO, exc_y == EXC_ZERO

    nan = x_nan | y_nan | (x_inf & y_inf & sub)
    inf = (~nan) & (x_inf | y_inf | (x_norm & y_norm & overflow))
    # zero result: both zero, or exact cancellation, or underflow flush
    cancel = x_norm & y_norm & mag_zero
    zero = (~nan) & (~inf) & ((x_zero & y_zero) | cancel
                              | (x_norm & y_norm & underflow))
    # pass-through: one operand zero, other normal
    pass_x = x_norm & y_zero
    pass_y = y_norm & x_zero

    exc = xp.where(nan, EXC_NAN,
                   xp.where(inf, EXC_INF,
                            xp.where(zero, EXC_ZERO, EXC_NORMAL)))
    sign = xp.where(x_inf, sx, xp.where(y_inf, sy, s_big))
    sign = xp.where(zero & ~(x_zero & y_zero), 0, sign)     # exact cancel -> +0
    sign = xp.where(x_zero & y_zero, sx & sy, sign)
    sign = xp.where(nan, 0, sign)

    e_out = xp.clip(e_res, 0, fmt.emax)
    f_out = frac_out
    e_out = xp.where(pass_x, ex, xp.where(pass_y, ey, e_out))
    f_out = xp.where(pass_x, fx, xp.where(pass_y, fy, f_out))
    sign = xp.where(pass_x, sx, xp.where(pass_y, sy, sign))
    return pack(exc, sign, e_out, f_out, fmt, xp)




# ---------------------------------------------------------------------------
# Format cast: (fmt_in) -> fmt_out, re-rounding the significand
# ---------------------------------------------------------------------------
def fp_cast(x, fmt_in: FPFormat, fmt_out: FPFormat, rounding: str = RNE,
            xp=np):
    """FloPoCo-semantics format conversion on code words.

    Re-biases the exponent and re-rounds the significand into
    ``fmt_out`` (exact when ``fmt_out.w_f >= fmt_in.w_f``).  Overflow
    saturates to infinity, underflow flushes to +0 (matching the
    mul/encode datapaths); exact zeros keep their sign.  For formats
    whose values are exactly representable in float32 this agrees
    bit-for-bit with ``encode(decode(x, fmt_in), fmt_out)`` — decode is
    exact, so there is no double rounding.  This is the inter-layer
    boundary operation of the bitslice-resident pipeline (DESIGN.md §8);
    the gate-level twin is ``fpcore.build_cast``.
    """
    exc, sign, exp, frac = unpack(x, fmt_in, xp)
    idt = _idt(xp)

    shift = fmt_out.w_f - fmt_in.w_f
    if shift >= 0:
        frac_r = frac << shift
        carry = xp.zeros_like(frac)
    else:
        frac_r = _round_drop(frac, -shift, rounding, xp)
        carry = (frac_r >> fmt_out.w_f) & 1       # rounded up to 2.0
        frac_r = xp.where(carry == 1, 0, frac_r) & ((1 << fmt_out.w_f) - 1)

    e_res = exp - fmt_in.bias + fmt_out.bias + carry
    underflow = e_res < 0
    overflow = e_res > fmt_out.emax

    x_norm = exc == EXC_NORMAL
    nan = exc == EXC_NAN
    inf = (~nan) & ((exc == EXC_INF) | (x_norm & overflow))
    zero = (~nan) & (~inf) & ((exc == EXC_ZERO) | (x_norm & underflow))
    exc_out = xp.where(nan, EXC_NAN,
                       xp.where(inf, EXC_INF,
                                xp.where(zero, EXC_ZERO, EXC_NORMAL)))
    sign = xp.where(nan, 0, sign)
    sign = xp.where(x_norm & underflow & zero, 0, sign)  # flush is +0
    e_res = xp.clip(e_res, 0, fmt_out.emax).astype(idt)
    return pack(exc_out, sign, e_res, frac_r, fmt_out, xp)


def fp_max(x, y, fmt: FPFormat, xp=np):
    """FloPoCo-semantics FP maximum on code words.

    Ordering: -inf < negative normals < zeros < positive normals < +inf,
    with magnitudes compared as (exp, frac).  NaN propagates: if either
    operand is NaN the result is the canonical +NaN code.  ``max(+0, -0)``
    and ``max(-0, +0)`` are both +0 (a positive sign wins a sign
    disagreement); ``max(-0, -0)`` is -0.  The result is always one of
    the (canonical) operand codes, so no rounding occurs.  Gate-level
    twin: ``fpcore.build_max`` (tests check exhaustive agreement).  This
    is the maxpool reduction op of the plane-resident pipeline.
    """
    idt = _idt(xp)
    exc_x, sx, ex, fx = unpack(x, fmt, xp)
    exc_y, sy, ey, fy = unpack(y, fmt, xp)
    x_norm = exc_x == EXC_NORMAL
    y_norm = exc_y == EXC_NORMAL
    # Magnitude key: (level, exp, frac); level 0=zero, 1=normal, 2=inf.
    # Canonical non-normals carry zero exp/frac so the key is monotone.
    lvl_x = xp.where(exc_x == EXC_INF, 2, xp.where(x_norm, 1, 0))
    lvl_y = xp.where(exc_y == EXC_INF, 2, xp.where(y_norm, 1, 0))
    shift = fmt.w_e + fmt.w_f
    mag_x = (lvl_x.astype(idt) << shift) | xp.where(x_norm, (ex << fmt.w_f)
                                                    | fx, 0)
    mag_y = (lvl_y.astype(idt) << shift) | xp.where(y_norm, (ey << fmt.w_f)
                                                    | fy, 0)
    # signs differ: the non-negative operand wins; same sign: larger
    # magnitude wins when positive, smaller when negative.
    take_y = xp.where(sx != sy, sx == 1,
                      xp.where(sx == 1, mag_y < mag_x, mag_x < mag_y))
    out = xp.where(take_y, xp.asarray(y).astype(idt),
                   xp.asarray(x).astype(idt))
    nan = (exc_x == EXC_NAN) | (exc_y == EXC_NAN)
    nan_code = int(pack(EXC_NAN, 0, 0, 0, fmt))
    return xp.where(nan, nan_code, out)


def fp_scale(x, k: int, fmt: FPFormat, xp=np):
    """FloPoCo-semantics multiply by 2**-k (k >= 0 static) on code words.

    Exact on the significand (a pure exponent decrement); underflow
    flushes to +0 like the mul/cast datapaths; zero/inf/NaN pass
    through.  Gate-level twin: ``fpcore.build_scale``.  With ``k =
    log2(window)`` this is the divider-free final step of an average
    pool (add-tree + scale).
    """
    assert k >= 0, k
    exc, sign, exp, frac = unpack(x, fmt, xp)
    e_res = exp - k
    x_norm = exc == EXC_NORMAL
    underflow = x_norm & (e_res < 0)
    exc_out = xp.where(underflow, EXC_ZERO, exc)
    sign = xp.where(underflow, 0, sign)           # flush is +0
    e_res = xp.clip(e_res, 0, fmt.emax)
    return pack(exc_out, sign, e_res, frac, fmt, xp)


def fp_relu(x, fmt: FPFormat, xp=np):
    """ReLU on code words: any code with the sign bit set — negative
    normals, -0, -inf, and (non-canonical) negative NaN — becomes the
    canonical +0 code; everything else passes through unchanged.
    Canonical NaN carries sign 0 and therefore propagates.  This is the
    word-parallel twin of ``conv2d_bitslice.ops.hobflops_relu_planes``
    (one ANDN per plane); tests check exhaustive agreement.
    """
    idt = _idt(xp)
    codes = xp.asarray(x).astype(idt)
    sign = (codes >> fmt.sign_off) & 1
    return xp.where(sign == 1, 0, codes)


def fp_mac(x, y, acc, fmt_in: FPFormat, fmt_out: FPFormat,
           rounding: str = RNE, xp=np):
    """HOBFLOPS MAC semantics: round the product to fmt_out, then add to
    the fmt_out accumulator (two roundings, per the paper's mult+add)."""
    prod = fp_mul(x, y, fmt_in, fmt_out, rounding, xp)
    return fp_add(prod, acc, fmt_out, rounding, xp)


# ---------------------------------------------------------------------------
# float32 <-> code conversion as pure integer/bitcast tensor ops.
# ---------------------------------------------------------------------------
def _pack_torch(exc, sign, exp, frac, fmt: FPFormat):
    """int32 field tensors -> int32 code words (canonical non-normals)."""
    normal = exc == EXC_NORMAL
    exp = torch.where(normal, exp, 0)
    frac = torch.where(normal, frac, 0)
    return (frac | (exp << fmt.exp_off) | (sign << fmt.sign_off)
            | (exc << fmt.exc_off)).to(torch.int32)


def encode_torch(x: torch.Tensor, fmt: FPFormat,
                 rounding: str = RNE) -> torch.Tensor:
    """float32 -> int32 codes via bit manipulation.  Subnormal f32
    inputs flush to zero (FloPoCo semantics has no subnormals anyway)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    sign = (bits >> 31) & 1
    exp8 = (bits >> 23) & 0xFF
    frac23 = bits & 0x7FFFFF
    isnan = (exp8 == 255) & (frac23 != 0)
    isinf = (exp8 == 255) & (frac23 == 0)
    iszero = exp8 == 0

    s = 23 - fmt.w_f
    if s > 0:
        keep = frac23 >> s
        if rounding == RNE:
            rem = frac23 & ((1 << s) - 1)
            half = 1 << (s - 1)
            round_up = (rem > half) | ((rem == half) & ((keep & 1) == 1))
            keep = keep + round_up.to(torch.int32)
        elif rounding != RTZ:
            raise ValueError(rounding)
    else:
        keep = frac23 << (-s)
    carry = keep >> fmt.w_f
    frac = torch.where(carry == 1, 0, keep) & ((1 << fmt.w_f) - 1)
    e = exp8 - 127 + fmt.bias + carry

    exc = torch.where(isnan, EXC_NAN,
                      torch.where(isinf | (e > fmt.emax), EXC_INF,
                                  torch.where(iszero | (e < 0),
                                              EXC_ZERO, EXC_NORMAL)))
    exc = exc.to(torch.int32)
    sign = torch.where(isnan, 0, sign)
    sign = torch.where((e < 0) & ~iszero & ~isinf & ~isnan, 0, sign)
    e = torch.clamp(e, 0, fmt.emax)
    return _pack_torch(exc, sign, e, frac, fmt)


def decode_torch(codes: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """int32 codes -> float32 via bit assembly.  Exact when the format's
    value range maps onto f32 normals (true for all w_e <= 7 formats; for
    w_e == 8 the very bottom exponent decodes as zero)."""
    codes = codes.to(torch.int32)
    frac = codes & ((1 << fmt.w_f) - 1)
    exp = (codes >> fmt.exp_off) & ((1 << fmt.w_e) - 1)
    sign = (codes >> fmt.sign_off) & 1
    exc = (codes >> fmt.exc_off) & 3
    e8 = exp - fmt.bias + 127
    frac32 = (frac << (23 - fmt.w_f)) if fmt.w_f <= 23 else (
        frac >> (fmt.w_f - 23))
    ok = (e8 >= 1) & (e8 <= 254)
    bits = ((sign << 31) | (torch.clamp(e8, 1, 254) << 23)
            | (frac32 & 0x7FFFFF)).to(torch.int32)
    val = bits.view(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=codes.device)
    val = torch.where(ok, val, zero)
    sgn = torch.where(sign == 1, -1.0, 1.0).to(torch.float32)
    val = torch.where(exc == EXC_ZERO, 0.0 * sgn, val)
    val = torch.where(exc == EXC_INF, float("inf") * sgn, val)
    val = torch.where(exc == EXC_NAN, float("nan"), val)
    return val


# ---------------------------------------------------------------------------
# StorageFormat (exception-free) weight codes.
# ---------------------------------------------------------------------------
FLT_MIN = 2.0 ** -126   # the smallest normal float32


def flush_subnormal(t, xp=torch):
    """Subnormal float32 values -> zero of the same sign.

    The reference's platforms flush subnormals (XLA on the CPU runs with
    flush-to-zero and denormals-are-zero, and the TPU has no
    subnormals), so the quantizer flushes where the reference's float
    arithmetic would: the scale, the weights it divides and the products
    of the dequantizer.  With a ``w_e = 8`` format the default scale,
    ``amax / 2**127``, is itself subnormal and flushes to 0, as it does
    in the reference."""
    return xp.where(abs(t) < FLT_MIN, t * 0, t)


def encode_storage(x: torch.Tensor, sfmt: StorageFormat,
                   rounding: str = RNE) -> torch.Tensor:
    """float32 -> StorageFormat codes (int32).  Saturating: inf/nan and
    overflow clamp to the max-magnitude finite code; underflow flushes
    to the zero code."""
    fmt = FPFormat(sfmt.w_e, sfmt.w_f)
    codes = encode_torch(x, fmt, rounding)
    frac = codes & ((1 << fmt.w_f) - 1)
    exp = (codes >> fmt.exp_off) & ((1 << fmt.w_e) - 1)
    sign = (codes >> fmt.sign_off) & 1
    exc = (codes >> fmt.exc_off) & 3
    # nudge +/-2^-bias (exp=0, frac=0) to frac=1 so code 0 stays "zero"
    frac = torch.where((exc == EXC_NORMAL) & (exp == 0) & (frac == 0),
                       1, frac)
    # saturate inf/nan to max finite
    sat = (exc == EXC_INF) | (exc == EXC_NAN)
    exp = torch.where(sat, sfmt.emax, exp)
    frac = torch.where(sat, (1 << sfmt.w_f) - 1, frac)
    normal = (exc == EXC_NORMAL) | sat
    code = torch.where(normal, frac | (exp << sfmt.w_f)
                       | (sign << (sfmt.w_e + sfmt.w_f)), 0)
    return code.to(torch.int32)


def decode_storage(codes: torch.Tensor, sfmt: StorageFormat) -> torch.Tensor:
    """StorageFormat codes -> float32 by bit assembly; code 0 is +0."""
    c = codes.to(torch.int32)
    frac = c & ((1 << sfmt.w_f) - 1)
    exp = (c >> sfmt.w_f) & ((1 << sfmt.w_e) - 1)
    sign = (c >> (sfmt.w_e + sfmt.w_f)) & 1
    e8 = exp - sfmt.bias + 127
    bits = ((sign << 31) | (e8 << 23)
            | (frac << (23 - sfmt.w_f))).to(torch.int32)
    val = bits.view(torch.float32)
    return torch.where(c == 0, torch.zeros((), dtype=torch.float32,
                                           device=c.device), val)


def decode_storage_np(codes: np.ndarray, sfmt: StorageFormat) -> np.ndarray:
    """numpy twin of :func:`decode_storage`: the host-side check of a
    decode done on the card."""
    c = np.asarray(codes).astype(np.int64)
    frac = c & ((1 << sfmt.w_f) - 1)
    exp = (c >> sfmt.w_f) & ((1 << sfmt.w_e) - 1)
    sign = (c >> (sfmt.w_e + sfmt.w_f)) & 1
    e8 = exp - sfmt.bias + 127
    bits = (sign << 31) | (e8 << 23) | (frac << (23 - sfmt.w_f))
    val = bits.astype(np.uint32).view(np.float32)
    return np.where(c == 0, np.float32(0.0), val)
