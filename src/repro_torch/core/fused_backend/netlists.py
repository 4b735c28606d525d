"""The two netlists of the multiply-ahead fused kernel.

``build_mac_chain`` (``core/fpcore.py``) runs k MACs,
``add(mul(x_j, y_j), acc)``, with the product kept unpacked between
the multiplier and the adder.  The fused kernel splits each MAC: the
product of channel c does not depend on the accumulator, so producer
warps run :func:`build_mul_step` ahead into shared memory, and the
chain warps run :func:`build_add_chain` over the packed products.
``build_mac`` is ``mul_wires`` then ``add_wires`` — the product packed
and unpacked between them — and ``build_mac_chain`` is bit-exact to k of
it, so the split chain is bit-exact to ``build_mac_chain``.
"""
from __future__ import annotations

from repro_torch.core.circuit import Graph
from repro_torch.core.fpcore import add_val, mul_wires, pack_val, unpack_val
from repro_torch.core.fpformat import RNE, FPFormat


def build_mul_step(fmt_in: FPFormat, extended: bool = False,
                   rounding: str = RNE) -> Graph:
    """One product in the accumulator format: inputs ``x0``, ``y0``
    (operand format), output ``out`` (``fmt_in.mult_out(extended)``)."""
    g = Graph()
    x = g.input_bus("x0", fmt_in.nbits)
    y = g.input_bus("y0", fmt_in.nbits)
    g.output_bus("out", mul_wires(g, x, y, fmt_in,
                                  fmt_in.mult_out(extended), rounding))
    return g


def build_add_chain(fmt_in: FPFormat, k: int, extended: bool = False,
                    rounding: str = RNE) -> Graph:
    """k adds fused into one netlist,
    ``out = add(p_{k-1}, ... add(p_0, acc) ...)``: inputs ``p0..p{k-1}``
    (packed products) and ``acc``, output ``out``, all in the
    accumulator format.  The accumulator stays unpacked between steps,
    as in ``build_mac_chain``."""
    assert k >= 1
    fmt_out = fmt_in.mult_out(extended)
    g = Graph()
    ps = [g.input_bus(f"p{i}", fmt_out.nbits) for i in range(k)]
    acc = g.input_bus("acc", fmt_out.nbits)
    accv = unpack_val(g, acc, fmt_out)
    for p in ps:
        accv = add_val(g, unpack_val(g, p, fmt_out), accv, fmt_out,
                       rounding)
    g.output_bus("out", pack_val(g, accv, fmt_out))
    return g
