"""FloPoCo-style custom floating-point formats.

A HOBFLOPS number (following FloPoCo's encoding, which the paper uses) is
the bit-vector

    [ exc(2) | sign(1) | exponent(w_e) | fraction(w_f) ]

with the exception field: 00 = zero, 01 = normal, 10 = +/-inf, 11 = NaN.
There are no subnormals; the significand always carries an implicit
leading 1, and every exponent code 0 .. 2^w_e - 1 encodes a normal
number.  Underflow flushes to zero, overflow saturates to infinity.

In an integer code word we store the fraction in the low bits:

    code = frac | exp << w_f | sign << (w_f+w_e) | exc << (w_f+w_e+1)

NINBITS per the paper == FPFormat.nbits == 2 + 1 + w_e + w_f.
"""
from __future__ import annotations

import dataclasses

EXC_ZERO = 0
EXC_NORMAL = 1
EXC_INF = 2
EXC_NAN = 3

RNE = "rne"  # round to nearest, ties to even
RTZ = "rtz"  # round towards zero


@dataclasses.dataclass(frozen=True, order=True)
class FPFormat:
    """A custom-precision FP format: w_e exponent bits, w_f fraction bits."""
    w_e: int
    w_f: int

    def __post_init__(self):
        assert self.w_e >= 2 and self.w_f >= 1

    @property
    def nbits(self) -> int:
        return self.w_f + self.w_e + 3

    @property
    def bias(self) -> int:
        return (1 << (self.w_e - 1)) - 1

    @property
    def emax(self) -> int:
        return (1 << self.w_e) - 1  # max biased exponent code

    # Field offsets within the code word (LSB first).
    @property
    def exp_off(self) -> int:
        return self.w_f

    @property
    def sign_off(self) -> int:
        return self.w_f + self.w_e

    @property
    def exc_off(self) -> int:
        return self.w_f + self.w_e + 1

    def mult_out(self, extended: bool = False) -> "FPFormat":
        """Output format of the HOBFLOPS multiplier (paper Table 3):
        single precision keeps w_f+1 fraction bits; extended keeps the
        exact product with 2*w_f+1 fraction bits."""
        return FPFormat(self.w_e, 2 * self.w_f + 1 if extended else self.w_f + 1)

    def max_value(self) -> float:
        return float((2.0 - 2.0 ** -self.w_f) * 2.0 ** (self.emax - self.bias))

    def min_normal(self) -> float:
        return float(2.0 ** (-self.bias))

    def __str__(self) -> str:
        return f"e{self.w_e}m{self.w_f}"


# The evaluated HOBFLOPS family (paper Table 3).  Inputs to the MAC; the
# accumulator runs at fmt.mult_out(extended).
HOBFLOPS_FORMATS: dict[str, FPFormat] = {
    "hobflops_ieee8": FPFormat(4, 3),   # Minifloat / IEEE-style FP8
    "hobflops8": FPFormat(5, 2),        # == MS-FP8
    "hobflops9": FPFormat(5, 3),        # == MS-FP9
    "hobflops10": FPFormat(5, 4),
    "hobflops11": FPFormat(5, 5),
    "hobflops12": FPFormat(5, 6),
    "hobflops13": FPFormat(5, 7),
    "hobflops14": FPFormat(5, 8),
    "hobflops15": FPFormat(5, 9),
    "hobflops16": FPFormat(5, 10),      # IEEE-FP16-shaped (no subnormals)
    "bfloat16": FPFormat(8, 7),         # beyond-paper: bf16-shaped custom FP
}


@dataclasses.dataclass(frozen=True, order=True)
class StorageFormat:
    """Exception-free storage layout for HOBFLOPS-quantized weights.

    Weights are finite, so the 2-bit FloPoCo exception field is dropped
    for storage: ``code = frac | exp << w_f | sign << (w_e + w_f)``,
    with code == 0 meaning exactly zero (the point +2^-bias with frac 0
    is nudged to frac 1 at quantization time).  nbits = 1 + w_e + w_f;
    the bitplane layout stores exactly nbits bits per weight in HBM.
    """
    w_e: int
    w_f: int

    @property
    def nbits(self) -> int:
        return 1 + self.w_e + self.w_f

    @property
    def bias(self) -> int:
        return (1 << (self.w_e - 1)) - 1

    @property
    def emax(self) -> int:
        return (1 << self.w_e) - 1

    @property
    def compute(self) -> FPFormat:
        return FPFormat(self.w_e, self.w_f)

    def container(self) -> str:
        """Narrowest native dtype holding one code ('int8'/'int16')."""
        return "int8" if self.nbits <= 8 else "int16"

    def __str__(self) -> str:
        return f"s_e{self.w_e}m{self.w_f}"


def parse_format(name: str) -> FPFormat:
    """Accepts 'hobflops9', 'e5m3', or 'fp16'-style names."""
    name = name.lower()
    if name in HOBFLOPS_FORMATS:
        return HOBFLOPS_FORMATS[name]
    if name.startswith("e") and "m" in name:
        we, wf = name[1:].split("m")
        return FPFormat(int(we), int(wf))
    raise ValueError(f"unknown FP format {name!r}")
