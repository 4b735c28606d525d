"""Pure numpy oracle for the bitslice MAC (HOBFLOPS GEMM).

Semantics: a HOBFLOPS inner product with sequential accumulation in
channel order, exactly as the paper's convolution performs it::

    O[p, m] = fold_c  add(mul(I[p, c], W[c, m]), acc)      # acc0 = +0

with the multiply rounding into the accumulator format
``fmt.mult_out(extended)`` and the add performed at that format.
Operates on integer code words (see repro_torch.core.fpformat).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import softfloat as sf
from repro_torch.core.fpformat import RNE, FPFormat


def hobflops_matmul_ref(i_codes, w_codes, fmt: FPFormat,
                        extended: bool = False, rounding: str = RNE,
                        xp=np):
    """i_codes: [P, C] int, w_codes: [C, M] int -> [P, M] int codes."""
    fmt_out = fmt.mult_out(extended)
    i_codes = xp.asarray(i_codes)
    w_codes = xp.asarray(w_codes)
    P, C = i_codes.shape
    C2, M = w_codes.shape
    assert C == C2
    acc = xp.zeros((P, M), dtype=xp.int64 if xp is np else xp.int32)
    for c in range(C):
        x = xp.broadcast_to(i_codes[:, c][:, None], (P, M))
        y = xp.broadcast_to(w_codes[c][None, :], (P, M))
        prod = sf.fp_mul(x, y, fmt, fmt_out, rounding, xp)
        acc = sf.fp_add(prod, acc, fmt_out, rounding, xp)
    return acc


def hobflops_matmul_f64(i_vals, w_vals, fmt: FPFormat,
                        extended: bool = False,
                        rounding: str = RNE) -> np.ndarray:
    """Float-in/float-out convenience oracle (encodes, MACs, decodes)."""
    fmt_out = fmt.mult_out(extended)
    ic = sf.encode(np.asarray(i_vals, np.float64), fmt, rounding)
    wc = sf.encode(np.asarray(w_vals, np.float64), fmt, rounding)
    out = hobflops_matmul_ref(ic, wc, fmt, extended, rounding)
    return sf.decode(out, fmt_out)
