"""Gate-level FloPoCo-style FP multiplier / adder circuit generators.

These builders play the role of FloPoCo in the paper's flow: they emit
combinational circuits (over :mod:`repro.core.circuit`) implementing
custom-precision FP arithmetic with the exact same semantics as the
word-parallel oracle in :mod:`repro.core.softfloat` — the tests check
bit-exact agreement, exhaustively for small formats.

Circuits assume *canonical* input codes (non-normal values carry zero
exponent/fraction fields), which is what ``softfloat.pack`` and
``softfloat.encode`` produce, and they emit canonical outputs.

Internally the datapath operates on an *unpacked* value (:class:`FPVal`:
decoded exception flags + sign + raw exponent/fraction wires).  Packing
to the canonical code layout masks the fields of non-normal values and
re-encodes the exception bits; unpacking re-decodes them.  A fused
multi-step pipeline (``build_mac_chain``) keeps intermediate results in
unpacked form, so the pack/unpack canonicalization — and its gates — is
paid once per chain instead of once per accumulation step.  This is
sound because every consumer of an FPVal either gates the field wires
by the ``normal`` flag or selects the result from the flags alone, so
garbage exponent/fraction wires on non-normal values never reach an
output (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses

from . import blocks as B
from .circuit import FALSE, TRUE, Graph
from .fpformat import RNE, RTZ, FPFormat

_GUARD = 3  # must match softfloat._GUARD


# ---------------------------------------------------------------------------
# Field helpers
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FPVal:
    """An FP value as wires: one-hot exception flags + raw datapath fields.

    ``exp``/``frac`` are only meaningful when ``normal`` is set; packing
    masks them to zero otherwise (the canonical encoding).
    """
    zero: int
    normal: int
    inf: int
    nan: int
    sign: int
    exp: list[int]
    frac: list[int]


def split_fields(bus: list[int], fmt: FPFormat):
    """code bus (LSB first) -> (exc2, sign, exp, frac) wire groups."""
    f = bus[0:fmt.w_f]
    e = bus[fmt.w_f:fmt.w_f + fmt.w_e]
    s = bus[fmt.sign_off]
    exc = bus[fmt.exc_off:fmt.exc_off + 2]  # [exc0, exc1]
    return exc, s, e, f


def exc_flags(g: Graph, exc: list[int]):
    """-> (is_zero, is_normal, is_inf, is_nan)."""
    e0, e1 = exc
    return (g.AND(g.NOT(e1), g.NOT(e0)),
            g.AND(g.NOT(e1), e0),
            g.AND(e1, g.NOT(e0)),
            g.AND(e1, e0))


def unpack_val(g: Graph, bus: list[int], fmt: FPFormat) -> FPVal:
    """Canonical code bus -> unpacked FPVal (flags decoded)."""
    exc, s, e, f = split_fields(bus, fmt)
    zero, normal, inf, nan = exc_flags(g, exc)
    return FPVal(zero, normal, inf, nan, s, list(e), list(f))


def pack_val(g: Graph, v: FPVal, fmt: FPFormat) -> list[int]:
    """Unpacked FPVal -> canonical code bus (fields masked unless normal)."""
    bus = [g.AND(b, v.normal) for b in v.frac[:fmt.w_f]]
    bus += [g.AND(b, v.normal) for b in v.exp[:fmt.w_e]]
    exc1 = g.OR(v.nan, v.inf)
    exc0 = g.OR(v.nan, v.normal)
    bus += [v.sign, exc0, exc1]
    assert len(bus) == fmt.nbits
    return bus


def pack_fields(g: Graph, exc0: int, exc1: int, sign: int,
                exp: list[int], frac: list[int], fmt: FPFormat) -> list[int]:
    """Assemble a canonical code bus: exp/frac masked unless normal."""
    normal = g.AND(g.NOT(exc1), exc0)
    bus = [g.AND(b, normal) for b in frac]
    bus += [g.AND(b, normal) for b in exp]
    bus += [sign, exc0, exc1]
    assert len(bus) == fmt.nbits
    return bus


def _round_bits(g: Graph, kept: list[int], rnd: int, sticky: int,
                rounding: str) -> tuple[list[int], int]:
    """Round `kept` given round bit + sticky.  Returns (rounded, carry)."""
    if rounding == RTZ:
        return list(kept), FALSE
    assert rounding == RNE
    round_up = g.AND(rnd, g.OR(sticky, kept[0]))
    return B.increment(g, kept, round_up)


# ---------------------------------------------------------------------------
# Multiplier
# ---------------------------------------------------------------------------
def mul_val(g: Graph, xv: FPVal, yv: FPVal, fmt_in: FPFormat,
            fmt_out: FPFormat, rounding: str = RNE) -> FPVal:
    """Unpacked-domain FP multiply: FPVal x FPVal -> FPVal."""
    assert fmt_out.w_e == fmt_in.w_e
    wf, we = fmt_in.w_f, fmt_in.w_e
    fx, ex = xv.frac, xv.exp
    fy, ey = yv.frac, yv.exp

    sign = g.XOR(xv.sign, yv.sign)

    # Exact significand product (2wf+2 bits).
    prod = B.mul_unsigned(g, fx + [TRUE], fy + [TRUE])
    norm = prod[2 * wf + 1]
    # Normalized 1.f significand: 2wf+1 fraction bits.
    frac_full = [g.MUX(norm, prod[i], prod[i - 1] if i > 0 else FALSE)
                 for i in range(2 * wf + 1)]

    drop = (2 * wf + 1) - fmt_out.w_f
    if drop < 0:
        frac_r, carry = [FALSE] * (-drop) + frac_full, FALSE
    elif drop == 0:
        frac_r, carry = frac_full, FALSE
    else:
        kept = frac_full[drop:]
        rnd = frac_full[drop - 1]
        sticky = B.or_reduce(g, frac_full[:drop - 1])
        frac_r, carry = _round_bits(g, kept, rnd, sticky, rounding)
    frac_r = frac_r[:fmt_out.w_f]  # on carry the increment wrapped to 0

    # e_res = ex + ey + norm + carry - bias, in we+2-bit two's complement.
    # Two fused ripple chains: (ex + ey + norm), then (+ (2^W - bias) + carry).
    W = we + 2
    e_sum, _ = B.ripple_add(g, ex, ey, cin=norm, width=W)
    e_res, _ = B.ripple_add(g, e_sum,
                            B.const_bus(g, (1 << W) - fmt_in.bias, W),
                            cin=carry, width=W)
    neg = e_res[W - 1]
    underflow = neg
    overflow = g.AND(g.NOT(neg), e_res[we])

    x_zero, x_norm, x_inf, x_nan = xv.zero, xv.normal, xv.inf, xv.nan
    y_zero, y_norm, y_inf, y_nan = yv.zero, yv.normal, yv.inf, yv.nan
    nan = g.OR(g.OR(x_nan, y_nan),
               g.OR(g.AND(x_inf, y_zero), g.AND(x_zero, y_inf)))
    inf_raw = g.OR(g.OR(g.AND(x_inf, g.OR(y_inf, y_norm)),
                        g.AND(y_inf, x_norm)),
                   g.AND(g.AND(x_norm, y_norm), overflow))
    inf = g.AND(g.NOT(nan), inf_raw)
    zero_raw = g.OR(g.OR(g.AND(x_zero, g.OR(y_zero, y_norm)),
                         g.AND(y_zero, x_norm)),
                    g.AND(g.AND(x_norm, y_norm), underflow))
    zero = g.AND(g.AND(g.NOT(nan), g.NOT(inf)), zero_raw)
    normal = g.AND(g.NOT(nan), g.AND(g.NOT(inf), g.NOT(zero)))

    # underflow-flushed zeros are +0; zero-operand products keep XOR sign
    uf_zero = g.AND(g.AND(g.AND(x_norm, y_norm), underflow), zero)
    sign_out = g.AND(sign, g.NOT(g.OR(nan, uf_zero)))
    return FPVal(zero, normal, inf, nan, sign_out, e_res[:we], frac_r)


def mul_wires(g: Graph, x: list[int], y: list[int], fmt_in: FPFormat,
              fmt_out: FPFormat, rounding: str = RNE) -> list[int]:
    v = mul_val(g, unpack_val(g, x, fmt_in), unpack_val(g, y, fmt_in),
                fmt_in, fmt_out, rounding)
    return pack_val(g, v, fmt_out)


def build_mul(fmt_in: FPFormat, fmt_out: FPFormat,
              rounding: str = RNE) -> Graph:
    g = Graph()
    x = g.input_bus("x", fmt_in.nbits)
    y = g.input_bus("y", fmt_in.nbits)
    g.output_bus("out", mul_wires(g, x, y, fmt_in, fmt_out, rounding))
    return g


# ---------------------------------------------------------------------------
# Format cast: rebias exponent + re-round significand into fmt_out
# ---------------------------------------------------------------------------
def cast_val(g: Graph, xv: FPVal, fmt_in: FPFormat, fmt_out: FPFormat,
             rounding: str = RNE) -> FPVal:
    """Unpacked-domain format conversion: FPVal(fmt_in) -> FPVal(fmt_out).

    Gate-level twin of ``softfloat.fp_cast`` (same FloPoCo semantics:
    widening is exact, narrowing re-rounds, overflow saturates to inf,
    underflow flushes to +0, exact zeros keep their sign).  Like
    :func:`mul_val`/:func:`add_val` it tolerates garbage exp/frac wires
    on non-normal inputs — every non-normal outcome is selected from the
    exception flags alone — so it composes after a MAC chain without an
    intervening canonical pack.
    """
    wf_i, wf_o = fmt_in.w_f, fmt_out.w_f
    we_i, we_o = fmt_in.w_e, fmt_out.w_e

    if wf_o >= wf_i:
        frac_r = [FALSE] * (wf_o - wf_i) + list(xv.frac[:wf_i])
        carry = FALSE
    else:
        drop = wf_i - wf_o
        kept = list(xv.frac[drop:wf_i])
        rnd = xv.frac[drop - 1]
        sticky = B.or_reduce(g, xv.frac[:drop - 1])
        frac_r, carry = _round_bits(g, kept, rnd, sticky, rounding)
        frac_r = frac_r[:wf_o]   # on carry the increment wrapped to 0

    # e_res = exp - bias_in + bias_out + carry, two's complement.
    W = max(we_i, we_o) + 2
    delta = (fmt_out.bias - fmt_in.bias) % (1 << W)
    e_ext = list(xv.exp[:we_i]) + [FALSE] * (W - we_i)
    e_res, _ = B.ripple_add(g, e_ext, B.const_bus(g, delta, W),
                            cin=carry, width=W)
    neg = e_res[W - 1]
    underflow = neg
    overflow = g.AND(g.NOT(neg), B.or_reduce(g, e_res[we_o:W - 1]))

    nan = xv.nan
    inf = g.OR(xv.inf, g.AND(xv.normal, overflow))
    uf_zero = g.AND(xv.normal, underflow)
    zero = g.OR(xv.zero, uf_zero)
    normal = g.AND(xv.normal, g.AND(g.NOT(underflow), g.NOT(overflow)))
    sign = g.AND(xv.sign, g.NOT(g.OR(nan, uf_zero)))
    return FPVal(zero, normal, inf, nan, sign, e_res[:we_o], frac_r)


def cast_wires(g: Graph, x: list[int], fmt_in: FPFormat, fmt_out: FPFormat,
               rounding: str = RNE) -> list[int]:
    v = cast_val(g, unpack_val(g, x, fmt_in), fmt_in, fmt_out, rounding)
    return pack_val(g, v, fmt_out)


def build_cast(fmt_in: FPFormat, fmt_out: FPFormat,
               rounding: str = RNE) -> Graph:
    """Combinational fmt_in -> fmt_out converter (input ``x``, output
    ``out``).  The bitslice-resident pipeline maps this through
    ``opt.optimize_mapped`` and runs it once per layer boundary to round
    the accumulator format back to the next layer's operand format."""
    g = Graph()
    x = g.input_bus("x", fmt_in.nbits)
    g.output_bus("out", cast_wires(g, x, fmt_in, fmt_out, rounding))
    return g


# ---------------------------------------------------------------------------
# Maximum: sign/magnitude FP compare-and-select (the maxpool reduction)
# ---------------------------------------------------------------------------
def max_val(g: Graph, xv: FPVal, yv: FPVal, fmt: FPFormat) -> FPVal:
    """Unpacked-domain FP maximum: max(FPVal, FPVal) -> FPVal.

    Gate-level twin of ``softfloat.fp_max``: total order
    -inf < negatives < zeros < positives < +inf, NaN propagating (to
    canonical +NaN), ``max(+0, -0) == +0``.  The datapath is one
    unsigned compare (``blocks.ucmp``) over a magnitude key plus field
    muxes — no rounding, the result is always one of the operands.

    Garbage-safe like :func:`mul_val`/:func:`add_val`: the key gates
    exp/frac by the ``normal`` flag and carries (normal, inf) as its top
    bits, so garbage fields on non-normal values never decide a compare
    against a different exception class, and every non-normal outcome is
    selected by the flags alone.
    """
    # Magnitude key (LSB first): [frac, exp] gated by normal, then the
    # level bits normal < inf (zero = 00, normal = 01, inf = 10).
    key_x = ([g.AND(b, xv.normal) for b in xv.frac + xv.exp]
             + [xv.normal, xv.inf])
    key_y = ([g.AND(b, yv.normal) for b in yv.frac + yv.exp]
             + [yv.normal, yv.inf])
    mag_lt, mag_gt = B.ucmp(g, key_x, key_y)

    # signs differ: the non-negative operand wins; same sign: larger
    # magnitude wins when positive, smaller when negative.
    sign_diff = g.XOR(xv.sign, yv.sign)
    take_y = g.MUX(sign_diff, xv.sign, g.MUX(xv.sign, mag_gt, mag_lt))

    nan = g.OR(xv.nan, yv.nan)
    zero = g.AND(g.MUX(take_y, yv.zero, xv.zero), g.NOT(nan))
    normal = g.AND(g.MUX(take_y, yv.normal, xv.normal), g.NOT(nan))
    inf = g.AND(g.MUX(take_y, yv.inf, xv.inf), g.NOT(nan))
    sign = g.AND(g.MUX(take_y, yv.sign, xv.sign), g.NOT(nan))
    exp = B.mux_bus(g, take_y, yv.exp, xv.exp)
    frac = B.mux_bus(g, take_y, yv.frac, xv.frac)
    return FPVal(zero, normal, inf, nan, sign, exp, frac)


def max_wires(g: Graph, x: list[int], y: list[int],
              fmt: FPFormat) -> list[int]:
    v = max_val(g, unpack_val(g, x, fmt), unpack_val(g, y, fmt), fmt)
    return pack_val(g, v, fmt)


def build_max(fmt: FPFormat) -> Graph:
    """Combinational elementwise FP max (inputs ``x``/``y``, output
    ``out``).  The plane-resident maxpool folds its window through this
    netlist — one compare-select per window element, entirely in the
    bitslice domain."""
    g = Graph()
    x = g.input_bus("x", fmt.nbits)
    y = g.input_bus("y", fmt.nbits)
    g.output_bus("out", max_wires(g, x, y, fmt))
    return g


# ---------------------------------------------------------------------------
# Power-of-two scale: exponent decrement (the avgpool divider)
# ---------------------------------------------------------------------------
def scale_val(g: Graph, xv: FPVal, fmt: FPFormat, k: int) -> FPVal:
    """Unpacked-domain multiply by 2**-k (k >= 0 static): a bare
    exponent decrement, exact on the significand.  Underflow flushes to
    +0 like :func:`cast_val`; zero/inf/NaN pass through.  Gate-level
    twin of ``softfloat.fp_scale``; garbage-safe like the other FPVal
    ops (the decremented exponent is only meaningful when ``normal``
    survives, and non-normal outcomes come from the flags alone).
    """
    assert k >= 0, k
    we = fmt.w_e
    if k > fmt.emax:
        # Every normal underflows (exp <= emax < k): flush them all to
        # +0.  Without this branch const_bus would truncate k to w_e
        # bits and scale by the wrong power.
        zero = g.OR(xv.zero, xv.normal)
        sign = g.AND(xv.sign, g.NOT(g.OR(xv.nan, xv.normal)))
        return FPVal(zero, FALSE, xv.inf, xv.nan, sign,
                     [FALSE] * we, xv.frac)
    diff, borrow = B.ripple_sub(g, xv.exp, B.const_bus(g, k, we))
    uf_zero = g.AND(xv.normal, borrow)
    zero = g.OR(xv.zero, uf_zero)
    normal = g.AND(xv.normal, g.NOT(borrow))
    sign = g.AND(xv.sign, g.NOT(g.OR(xv.nan, uf_zero)))
    return FPVal(zero, normal, xv.inf, xv.nan, sign, diff[:we], xv.frac)


def scale_wires(g: Graph, x: list[int], fmt: FPFormat, k: int) -> list[int]:
    v = scale_val(g, unpack_val(g, x, fmt), fmt, k)
    return pack_val(g, v, fmt)


def build_scale(fmt: FPFormat, k: int) -> Graph:
    """Combinational multiply-by-2**-k (input ``x``, output ``out``).
    With ``k = log2(window)`` this turns an average pool into add-tree +
    scale with no divider — the plane-resident pipeline's avgpool tail."""
    g = Graph()
    x = g.input_bus("x", fmt.nbits)
    g.output_bus("out", scale_wires(g, x, fmt, k))
    return g


# ---------------------------------------------------------------------------
# Adder
# ---------------------------------------------------------------------------
def add_val(g: Graph, xv: FPVal, yv: FPVal, fmt: FPFormat,
            rounding: str = RNE) -> FPVal:
    """Unpacked-domain FP add: FPVal + FPVal -> FPVal.

    Tolerates garbage exp/frac wires on non-normal inputs: the swap
    comparison key carries the ``normal`` flag as its MSB (so a normal
    value always outranks a non-normal one), significands are gated by
    the normal flags before the datapath, and all non-normal outcomes
    are selected by the flag logic alone.
    """
    wf, we, G = fmt.w_f, fmt.w_e, _GUARD
    W = wf + 1 + G
    assert wf + G + 2 < (1 << (we + 1)), "exponent range too small for datapath"
    sx, ex, fx = xv.sign, xv.exp, xv.frac
    sy, ey, fy = yv.sign, yv.exp, yv.frac
    x_zero, x_norm, x_inf, x_nan = xv.zero, xv.normal, xv.inf, xv.nan
    y_zero, y_norm, y_inf, y_nan = yv.zero, yv.normal, yv.inf, yv.nan

    # Magnitude comparison key: (normal, exp, frac); non-normals carry
    # the normal flag as MSB so they always lose against normals, and
    # garbage fields between two non-normals never affect the result.
    key_x = list(fx) + list(ex) + [x_norm]
    key_y = list(fy) + list(ey) + [y_norm]
    swap = B.ult(g, key_x, key_y)

    s_big = g.MUX(swap, sy, sx)
    e_big = B.mux_bus(g, swap, ey, ex)
    f_big = B.mux_bus(g, swap, fy, fx)
    e_sml = B.mux_bus(g, swap, ex, ey)
    f_sml = B.mux_bus(g, swap, fx, fy)
    big_norm = g.MUX(swap, y_norm, x_norm)
    sml_norm = g.MUX(swap, x_norm, y_norm)

    # Significands with G guard bits, gated by the normal flags.
    sig_big = [FALSE] * G + [g.AND(b, big_norm) for b in f_big] + [big_norm]
    sig_sml_full = ([FALSE] * G + [g.AND(b, sml_norm) for b in f_sml]
                    + [sml_norm])

    d, _ = B.ripple_sub(g, e_big, e_sml)  # >= 0 when both operands normal
    sig_sml, sticky_in = B.shr_barrel(g, sig_sml_full, d, collect_sticky=True)
    sig_sml = [g.OR(sig_sml[0], sticky_in)] + sig_sml[1:]

    sub = g.XOR(sx, sy)
    addend = [g.XOR(b, sub) for b in sig_sml]
    summ, cout = B.ripple_add(g, sig_big, addend, cin=sub, width=W)
    mag = summ + [g.AND(cout, g.NOT(sub))]          # W+1 bits
    mag_zero = B.eq_zero(g, mag)

    carry_case = mag[W]
    # carry path: shift right one, keeping bit0 as sticky
    mag_r = [g.OR(mag[1], mag[0])] + mag[2:W + 1]   # W bits
    # left path: fused leading-zero count + shift (normalizer)
    mag_low = B.mux_bus(g, mag_zero, B.const_bus(g, 1, W), mag[:W])
    mag_l, lz = B.normalize_shift(g, mag_low)
    mag_n = B.mux_bus(g, carry_case, mag_r, mag_l)  # W bits, MSB normalized

    # e_res = e_big + 1 (carry) or e_big - lz, in we+2-bit two's complement
    WE = we + 2
    e_ext = list(e_big) + [FALSE, FALSE]
    e_inc, _ = B.ripple_add(g, e_ext, B.const_bus(g, 1, WE), width=WE)
    e_dec, _ = B.ripple_sub(g, e_ext, lz + [FALSE] * (WE - len(lz)), width=WE)
    e_res = B.mux_bus(g, carry_case, e_inc, e_dec)

    # rounding on the G guard bits
    kept = mag_n[G:]                                # wf+1 bits
    rnd = mag_n[G - 1]
    sticky = B.or_reduce(g, mag_n[:G - 1])
    frac_r, rcarry = _round_bits(g, kept, rnd, sticky, rounding)
    frac_out = frac_r[:wf]                          # on rcarry this is 0
    e_res, _ = B.ripple_add(g, e_res, B.const_bus(g, 0, WE),
                            cin=rcarry, width=WE)

    neg = e_res[WE - 1]
    underflow = neg
    overflow = g.AND(g.NOT(neg), e_res[we])

    both_norm = g.AND(x_norm, y_norm)
    nan = g.OR(g.OR(x_nan, y_nan), g.AND(g.AND(x_inf, y_inf), sub))
    inf = g.AND(g.NOT(nan),
                g.OR(g.OR(x_inf, y_inf), g.AND(both_norm, overflow)))
    cancel = g.AND(both_norm, mag_zero)
    both_zero = g.AND(x_zero, y_zero)
    zero = g.AND(g.AND(g.NOT(nan), g.NOT(inf)),
                 g.OR(g.OR(both_zero, cancel),
                      g.AND(both_norm, underflow)))
    pass_x = g.AND(x_norm, y_zero)
    pass_y = g.AND(y_norm, x_zero)
    normal = g.AND(g.NOT(nan), g.AND(g.NOT(inf), g.NOT(zero)))

    sign = g.MUX(x_inf, sx, g.MUX(y_inf, sy, s_big))
    sign = g.MUX(g.AND(zero, g.NOT(both_zero)), FALSE, sign)
    sign = g.MUX(both_zero, g.AND(sx, sy), sign)
    sign = g.AND(sign, g.NOT(nan))

    e_out = B.mux_bus(g, pass_x, ex, B.mux_bus(g, pass_y, ey, e_res[:we]))
    f_out = B.mux_bus(g, pass_x, fx, B.mux_bus(g, pass_y, fy, frac_out))
    sign = g.MUX(pass_x, sx, g.MUX(pass_y, sy, sign))
    return FPVal(zero, normal, inf, nan, sign, e_out, f_out)


def add_wires(g: Graph, x: list[int], y: list[int], fmt: FPFormat,
              rounding: str = RNE) -> list[int]:
    v = add_val(g, unpack_val(g, x, fmt), unpack_val(g, y, fmt),
                fmt, rounding)
    return pack_val(g, v, fmt)


def build_add(fmt: FPFormat, rounding: str = RNE) -> Graph:
    g = Graph()
    x = g.input_bus("x", fmt.nbits)
    y = g.input_bus("y", fmt.nbits)
    g.output_bus("out", add_wires(g, x, y, fmt, rounding))
    return g


# ---------------------------------------------------------------------------
# Fused MAC circuit: out = add(mul(x, y), acc) at accumulator precision.
# ---------------------------------------------------------------------------
def build_mac(fmt_in: FPFormat, extended: bool = False,
              rounding: str = RNE) -> Graph:
    fmt_out = fmt_in.mult_out(extended)
    g = Graph()
    x = g.input_bus("x", fmt_in.nbits)
    y = g.input_bus("y", fmt_in.nbits)
    acc = g.input_bus("acc", fmt_out.nbits)
    prod = mul_wires(g, x, y, fmt_in, fmt_out, rounding)
    g.output_bus("out", add_wires(g, prod, acc, fmt_out, rounding))
    return g


# ---------------------------------------------------------------------------
# Fused K-step MAC chain:
#   out = add(mul(x[k-1], y[k-1]), ... add(mul(x0, y0), acc) ...)
# ---------------------------------------------------------------------------
def build_mac_chain(fmt_in: FPFormat, k: int, extended: bool = False,
                    rounding: str = RNE) -> Graph:
    """K MAC steps fused into one netlist, bit-exact to ``k`` sequential
    :func:`build_mac` applications in channel order.

    Inputs: ``x0..x{k-1}``/``y0..y{k-1}`` (operand format) and ``acc``
    (accumulator format ``fmt_in.mult_out(extended)``); output ``out``.

    The intermediate accumulator stays in unpacked :class:`FPVal` form
    between steps, so the canonical pack (field masking + exception
    re-encode) and the matching unpack (exception re-decode) are elided
    at every mul->add and add->add boundary — 2k-1 boundaries' worth of
    gates per chain, paid once at the chain's output instead.
    """
    assert k >= 1
    fmt_out = fmt_in.mult_out(extended)
    g = Graph()
    xs = [g.input_bus(f"x{i}", fmt_in.nbits) for i in range(k)]
    ys = [g.input_bus(f"y{i}", fmt_in.nbits) for i in range(k)]
    acc = g.input_bus("acc", fmt_out.nbits)
    accv = unpack_val(g, acc, fmt_out)
    for i in range(k):
        xv = unpack_val(g, xs[i], fmt_in)
        yv = unpack_val(g, ys[i], fmt_in)
        pv = mul_val(g, xv, yv, fmt_in, fmt_out, rounding)
        accv = add_val(g, pv, accv, fmt_out, rounding)
    g.output_bus("out", pack_val(g, accv, fmt_out))
    return g
