"""A frozen copy of the HOBFLOPS softfloat oracle, over torch integer
tensors (int32 code words), so that the plain reference of the conv cells
runs on the card beside the program it judges.

HOBFLOPS numbers follow FloPoCo's encoding (HOBFLOPS, arXiv:2007.06563,
section 3; FloPoCo's FPMult and FPAdd)::

    code = frac | exp << w_f | sign << (w_e + w_f) | exc << (w_e + w_f + 1)

with the exception field 00 = zero, 01 = normal, 10 = inf, 11 = NaN; no
subnormals, underflow flushes to +0, overflow saturates to infinity.  A
MAC rounds the product into the accumulator format (``w_f + 1`` fraction
bits, the paper's Table 3) and adds it there, round to nearest even.

Written from that description; it imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import torch

EXC_ZERO, EXC_NORMAL, EXC_INF, EXC_NAN = 0, 1, 2, 3
GUARD = 3          # guard, round and sticky bits of the adder datapath
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Fmt:
    """A FloPoCo format: ``w_e`` exponent bits, ``w_f`` fraction bits."""
    w_e: int
    w_f: int

    @property
    def bias(self) -> int:
        return (1 << (self.w_e - 1)) - 1

    @property
    def emax(self) -> int:
        return (1 << self.w_e) - 1

    def acc(self) -> "Fmt":
        """The MAC's product and accumulator format."""
        return Fmt(self.w_e, self.w_f + 1)


def fmt_named(name: str) -> Fmt:
    """``hobflopsN`` (the paper's Table 3: e5 with N - 6 fraction bits,
    hobflops8 to hobflops16) or ``e<w_e>m<w_f>``."""
    name = name.lower()
    if name.startswith("hobflops") and name[8:].isdigit():
        n = int(name[8:])
        if 8 <= n <= 16:
            return Fmt(5, n - 6)
    if name.startswith("e") and "m" in name:
        we, wf = name[1:].split("m")
        return Fmt(int(we), int(wf))
    raise ValueError(f"unknown format {name!r}")


def fields(c, f: Fmt):
    """-> (exc, sign, exp, frac) int32 tensors."""
    c = c.to(I32)
    return ((c >> (f.w_e + f.w_f + 1)) & 3, (c >> (f.w_e + f.w_f)) & 1,
            (c >> f.w_f) & ((1 << f.w_e) - 1), c & ((1 << f.w_f) - 1))


def assemble(exc, sign, exp, frac, f: Fmt):
    """Fields -> code words; non-normal codes carry zero exp and frac."""
    normal = exc == EXC_NORMAL
    exp = torch.where(normal, exp, 0)
    frac = torch.where(normal, frac, 0)
    return (frac | (exp << f.w_f) | (sign << (f.w_e + f.w_f))
            | (exc << (f.w_e + f.w_f + 1))).to(I32)


def _classify(nan, inf, zero):
    return torch.where(nan, EXC_NAN, torch.where(
        inf, EXC_INF, torch.where(zero, EXC_ZERO, EXC_NORMAL))).to(I32)


def round_drop(v, drop: int):
    """``v >> drop`` rounded to nearest, ties to even."""
    if drop <= 0:
        return v << (-drop)
    kept = v >> drop
    rnd = (v >> (drop - 1)) & 1
    sticky = (v & ((1 << (drop - 1)) - 1)) != 0 if drop >= 2 \
        else torch.zeros_like(v, dtype=torch.bool)
    return kept + ((rnd == 1) & (sticky | ((kept & 1) == 1))).to(I32)


def encode_f32(x: torch.Tensor, f: Fmt) -> torch.Tensor:
    """float32 -> codes, round to nearest even; float32 subnormals and
    results below the format's smallest normal flush to +0 (an exact
    zero keeps its sign)."""
    bits = x.to(torch.float32).contiguous().view(I32)
    sign = (bits >> 31) & 1
    e8 = (bits >> 23) & 0xFF
    m23 = bits & 0x7FFFFF
    nan = (e8 == 255) & (m23 != 0)
    inf = (e8 == 255) & (m23 == 0)
    zero_in = e8 == 0
    s = 23 - f.w_f
    kept = round_drop(m23, s)
    carry = kept >> f.w_f
    frac = torch.where(carry == 1, 0, kept) & ((1 << f.w_f) - 1)
    e = e8 - 127 + f.bias + carry
    exc = _classify(nan, ~nan & (inf | (e > f.emax)),
                    ~nan & ~inf & (zero_in | (e < 0)))
    sign = torch.where(nan | ((e < 0) & ~zero_in & ~inf), 0, sign)
    return assemble(exc, sign, torch.clamp(e, 0, f.emax), frac, f)


def decode_f32(c: torch.Tensor, f: Fmt) -> torch.Tensor:
    """codes -> float32 (exact for w_e <= 7)."""
    exc, sign, exp, frac = fields(c, f)
    bits = (sign << 31) | ((exp - f.bias + 127) << 23) \
        | (frac << (23 - f.w_f))
    val = bits.to(I32).view(torch.float32)
    signed = torch.where(sign == 1, -1.0, 1.0).to(torch.float32)
    val = torch.where(exc == EXC_ZERO, 0.0 * signed, val)
    val = torch.where(exc == EXC_INF, float("inf") * signed, val)
    return torch.where(exc == EXC_NAN, float("nan"), val)


def mul(x, y, fi: Fmt, fo: Fmt):
    """FloPoCo multiply of two ``fi`` codes into ``fo`` (same w_e)."""
    wf = fi.w_f
    ex_x, sx, ux, fx = fields(x, fi)
    ex_y, sy, uy, fy = fields(y, fi)
    sign = sx ^ sy
    prod = (fx | (1 << wf)) * (fy | (1 << wf))
    top = (prod >> (2 * wf + 1)) & 1
    mask = (1 << (2 * wf + 1)) - 1
    full = torch.where(top == 1, prod & mask, (prod << 1) & mask)
    fr = round_drop(full, 2 * wf + 1 - fo.w_f)
    carry = (fr >> fo.w_f) & 1
    fr = torch.where(carry == 1, 0, fr) & ((1 << fo.w_f) - 1)
    e = ux + uy - fi.bias + top + carry
    xn, yn = ex_x == EXC_NORMAL, ex_y == EXC_NORMAL
    xz, yz = ex_x == EXC_ZERO, ex_y == EXC_ZERO
    xi, yi = ex_x == EXC_INF, ex_y == EXC_INF
    nan = (ex_x == EXC_NAN) | (ex_y == EXC_NAN) | (xi & yz) | (xz & yi)
    inf = ~nan & ((xi & (yi | yn)) | (yi & xn) | (xn & yn & (e > fo.emax)))
    zero = ~nan & ~inf & ((xz & (yz | yn)) | (yz & xn)
                          | (xn & yn & (e < 0)))
    sign = torch.where(nan | (xn & yn & (e < 0) & zero), 0, sign)
    return assemble(_classify(nan, inf, zero), sign,
                    torch.clamp(e, 0, fo.emax), fr, fo)


def add(x, y, f: Fmt):
    """FloPoCo add of two ``f`` codes (one datapath, flush to zero)."""
    wf = f.w_f
    width = wf + 1 + GUARD
    ex_x, sx, ux, fx = fields(x, f)
    ex_y, sy, uy, fy = fields(y, f)
    xn, yn = ex_x == EXC_NORMAL, ex_y == EXC_NORMAL
    mag_x = torch.where(xn, (ux << wf) | fx, -1)
    mag_y = torch.where(yn, (uy << wf) | fy, -1)
    swap = mag_y > mag_x
    s_big = torch.where(swap, sy, sx)
    e_big = torch.where(swap, uy, ux)
    f_big = torch.where(swap, fy, fx)
    e_sml = torch.where(swap, ux, uy)
    f_sml = torch.where(swap, fx, fy)
    big_n = torch.where(swap, yn, xn)
    sml_n = torch.where(swap, xn, yn)
    sig_big = torch.where(big_n, (f_big | (1 << wf)) << GUARD, 0)
    sig_sml_full = torch.where(sml_n, (f_sml | (1 << wf)) << GUARD, 0)
    d = torch.clamp(e_big - e_sml, 0, width + 1)
    sig_sml = (sig_sml_full >> d) | (
        (sig_sml_full & ((1 << d) - 1)) != 0).to(I32)
    sub = (sx ^ sy) == 1
    mag = torch.where(sub, sig_big - sig_sml, sig_big + sig_sml)
    mag_zero = mag == 0
    m = torch.where(mag_zero, 1, mag)
    lead = torch.zeros_like(m)
    for b in range(width + 1):
        lead = torch.where(((m >> b) & 1) == 1, b, lead)
    shl = (width - 1) - lead
    normed = torch.where(shl < 0, (mag >> 1) | (mag & 1),
                         mag << torch.clamp(shl, 0, width))
    e = e_big - torch.clamp(shl, -1, width)
    fr = round_drop(normed, GUARD)
    rc = (fr >> (wf + 1)) & 1
    fr = torch.where(rc == 1, fr >> 1, fr)
    e = e + rc
    xz, yz = ex_x == EXC_ZERO, ex_y == EXC_ZERO
    xi, yi = ex_x == EXC_INF, ex_y == EXC_INF
    nan = (ex_x == EXC_NAN) | (ex_y == EXC_NAN) | (xi & yi & sub)
    inf = ~nan & (xi | yi | (xn & yn & (e > f.emax)))
    zero = ~nan & ~inf & ((xz & yz) | (xn & yn & mag_zero)
                          | (xn & yn & (e < 0)))
    sign = torch.where(xi, sx, torch.where(yi, sy, s_big))
    sign = torch.where(zero & ~(xz & yz), 0, sign)
    sign = torch.where(xz & yz, sx & sy, sign)
    sign = torch.where(nan, 0, sign)
    pass_x, pass_y = xn & yz, yn & xz
    e_out = torch.where(pass_x, ux, torch.where(
        pass_y, uy, torch.clamp(e, 0, f.emax)))
    f_out = torch.where(pass_x, fx, torch.where(
        pass_y, fy, fr & ((1 << wf) - 1)))
    sign = torch.where(pass_x, sx, torch.where(pass_y, sy, sign))
    return assemble(_classify(nan, inf, zero), sign, e_out, f_out, f)


def cast(x, fi: Fmt, fo: Fmt):
    """Re-round ``fi`` codes into ``fo`` (same w_e or not); overflow
    saturates to infinity, underflow flushes to +0."""
    exc, sign, exp, frac = fields(x, fi)
    shift = fo.w_f - fi.w_f
    if shift >= 0:
        fr, carry = frac << shift, torch.zeros_like(frac)
    else:
        fr = round_drop(frac, -shift)
        carry = (fr >> fo.w_f) & 1
        fr = torch.where(carry == 1, 0, fr) & ((1 << fo.w_f) - 1)
    e = exp - fi.bias + fo.bias + carry
    xn = exc == EXC_NORMAL
    nan = exc == EXC_NAN
    inf = ~nan & ((exc == EXC_INF) | (xn & (e > fo.emax)))
    zero = ~nan & ~inf & ((exc == EXC_ZERO) | (xn & (e < 0)))
    sign = torch.where(nan | (xn & (e < 0) & zero), 0, sign)
    return assemble(_classify(nan, inf, zero), sign,
                    torch.clamp(e, 0, fo.emax), fr, fo)


def relu(x, f: Fmt):
    """A code with its sign bit set becomes the +0 code."""
    return torch.where(((x >> (f.w_e + f.w_f)) & 1) == 1, 0, x).to(I32)
