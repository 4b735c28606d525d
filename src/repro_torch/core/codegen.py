"""Netlist -> software translation (the paper's domain-specific generator).

Three consumers:

* ``eval_netlist``     — numpy interpreter over uint64 bit planes.  Used by
                         the exhaustive correctness tests (the analogue of
                         re-simulating the synthesized netlist against the
                         FloPoCo test bench).
* ``make_torch_fn``    — returns a function over int32 torch planes;
                         every gate becomes one elementwise bitwise torch
                         op over arbitrarily wide tensors.
* ``emit_source``      — generated C-like source text, for inspection
                         (mirrors the paper's generated C headers).

Gate scheduling: gates are emitted in topological order with a
register-allocation pass that reuses temporaries once their last reader
has executed — the software analogue of the paper's topological sort +
G++ register allocation.
"""
from __future__ import annotations

import weakref
from typing import Callable

import numpy as np
import torch

from .circuit import (FALSE, OP_AND, OP_ANDN, OP_CONST, OP_INPUT, OP_LUT3,
                      OP_MUX, OP_NOT, OP_OR, OP_XOR, TRUE, Graph)


def _schedule(graph: Graph):
    """Topo order of live logic nodes + last-use map for temp reuse."""
    order = graph.topo_order()
    last_use: dict[int, int] = {}
    for pos, nid in enumerate(order):
        n = graph.nodes[nid]
        for ch in (n.a, n.b, n.c):
            if ch >= 0:
                last_use[ch] = pos
    return order, last_use


def _slot_schedule(graph: Graph):
    """Register-allocated emission schedule.

    Returns ``(steps, nslots, out_wires)``.  Each step is
    ``(node_id, slot, child_slots, free_after)``: evaluate the node into
    ``slot``, reading operands from ``child_slots`` (-1 marks the
    FALSE/TRUE constants, resolved via the node's child ids), then
    return the ``free_after`` slots to the pool.  Output wires stay
    pinned for the whole schedule.  ``out_wires[name]`` is a list of
    ``("slot", s)`` / ``("const", 0|1)`` descriptors per bus bit.
    ``nslots`` is the peak register count — the analogue of the paper's
    topological sort + G++ register allocation over the generated C.
    """
    order, last_use = _schedule(graph)
    pinned = {w for bus in graph.outputs.values() for w in bus}
    slot_of: dict[int, int] = {}
    free: list[int] = []
    nslots = 0
    steps = []
    for pos, nid in enumerate(order):
        n = graph.nodes[nid]
        if nid in (FALSE, TRUE) or n.op == OP_CONST:
            continue
        if free:
            slot = free.pop()
        else:
            slot = nslots
            nslots += 1
        slot_of[nid] = slot
        children = [ch for ch in (n.a, n.b, n.c) if ch >= 0]
        child_slots = tuple(slot_of.get(ch, -1) for ch in children)
        free_after = [slot_of[ch] for ch in set(children)
                      if ch in slot_of and ch not in pinned
                      and last_use.get(ch, -1) == pos]
        steps.append((nid, slot, child_slots, free_after))
        free.extend(free_after)
    out_wires = {}
    for name, bus in graph.outputs.items():
        descs = []
        for w in bus:
            if w in slot_of:
                descs.append(("slot", slot_of[w]))
            else:
                node = graph.nodes[w]
                assert node.op == OP_CONST, f"unscheduled output wire {w}"
                descs.append(("const", 1 if node.aux else 0))
        out_wires[name] = descs
    return steps, nslots, out_wires


# ---------------------------------------------------------------------------
# numpy interpreter
# ---------------------------------------------------------------------------
def eval_netlist(graph: Graph, inputs: dict[str, np.ndarray],
                 xp=np) -> dict[str, np.ndarray]:
    """Evaluate the circuit over bit planes.

    ``inputs[name]`` must be an array whose leading axis indexes the bits
    of bus ``name`` (shape ``[width, ...lanes]``).  Returns planes of the
    same lane shape for every output bus.
    """
    sample = next(iter(inputs.values()))
    lane_shape = sample.shape[1:]
    dtype = sample.dtype
    if dtype.kind == "u":
        ones = xp.full(lane_shape, dtype.type(~dtype.type(0)), dtype=dtype)
    else:
        ones = xp.full(lane_shape, -1, dtype=dtype)
    zeros = xp.zeros(lane_shape, dtype=dtype)

    val: dict[int, np.ndarray] = {FALSE: zeros, TRUE: ones}
    for nid in graph.topo_order():
        if nid in val:
            continue
        n = graph.nodes[nid]
        if n.op == OP_INPUT:
            name, bit = n.aux
            val[nid] = xp.asarray(inputs[name][bit])
        elif n.op == OP_CONST:
            val[nid] = ones if n.aux else zeros
        elif n.op == OP_NOT:
            val[nid] = ~val[n.a]
        elif n.op == OP_AND:
            val[nid] = val[n.a] & val[n.b]
        elif n.op == OP_OR:
            val[nid] = val[n.a] | val[n.b]
        elif n.op == OP_XOR:
            val[nid] = val[n.a] ^ val[n.b]
        elif n.op == OP_ANDN:
            val[nid] = val[n.a] & ~val[n.b]
        elif n.op == OP_MUX:
            s, a, b = val[n.a], val[n.b], val[n.c]
            val[nid] = (s & a) | (~s & b)
        elif n.op == OP_LUT3:
            a, b, c = val[n.a], val[n.b], val[n.c]
            tt = n.aux
            acc = zeros
            for m in range(8):
                if (tt >> m) & 1:
                    t = ones
                    t = t & (a if m & 1 else ~a)
                    t = t & (b if m & 2 else ~b)
                    t = t & (c if m & 4 else ~c)
                    acc = acc | t
            val[nid] = acc
        else:  # pragma: no cover
            raise ValueError(f"bad op {n.op}")
    return {name: xp.stack([val[w] for w in bus])
            for name, bus in graph.outputs.items()}


# ---------------------------------------------------------------------------
# torch emission
# ---------------------------------------------------------------------------
def lut3_anf(tt: int) -> tuple[bool, list[int]]:
    """Algebraic normal form of a 3-input cell.

    Bit ``m`` of the truth table ``tt`` is the output for the input
    combination ``a + 2*b + 4*c`` (the netlist convention of
    ``circuit.OP_LUT3``; note that PTX ``lop3.b32`` numbers its table
    the other way round, ``4*a + 2*b + c``).  Returns ``(negate,
    monomials)``: the cell is the XOR of the monomials — each a bit
    mask over (a, b, c) naming the inputs it ANDs — complemented when
    ``negate`` (the constant-1 term).  At most 7 two-input ops, against
    up to 31 for the minterm expansion.
    """
    coef = [(tt >> m) & 1 for m in range(8)]
    for i in range(3):
        for m in range(8):
            if m & (1 << i):
                coef[m] ^= coef[m ^ (1 << i)]
    return bool(coef[0]), [m for m in range(1, 8) if coef[m]]


def lut3(tt: int, a, b, c, zeros):
    """A 3-input cell over lane words, through :func:`lut3_anf`."""
    negate, monos = lut3_anf(tt)
    ins = (a, b, c)
    v = None
    for m in monos:
        t = None
        for i in range(3):
            if m & (1 << i):
                t = ins[i] if t is None else t & ins[i]
        v = t if v is None else v ^ t
    if v is None:
        v = zeros
    return ~v if negate else v


# One function per live Graph object: repeated launches of the same
# netlist reuse the schedule and the closure instead of re-running
# register allocation.
_FN_CACHE: "weakref.WeakKeyDictionary[Graph, Callable]" = \
    weakref.WeakKeyDictionary()


def make_torch_fn(graph: Graph) -> Callable:
    """Returns f(**{name: planes}) -> {name: planes} over int32 tensors.

    Planes are int32 tensors [width, ...lanes] that broadcast against
    each other; each gate runs as one elementwise bitwise torch op
    (MUX as ``b ^ (s & (a ^ b))``, LUT3 through :func:`lut3_anf`).

    Gates execute on the slot-allocated schedule: temporaries are
    released at their last use and slots reused, so the peak number of
    live tensors matches a register-allocated C emission rather than
    growing with the netlist.  Results are cached per Graph instance.
    """
    cached = _FN_CACHE.get(graph)
    if cached is not None:
        return cached

    steps, nslots, out_wires = _slot_schedule(graph)
    nodes = graph.nodes

    def fn(**inputs):
        sample = next(iter(inputs.values()))
        zeros = torch.zeros_like(sample[0])
        ones = ~zeros
        env: list = [None] * nslots

        def rd(slot, child):
            if slot >= 0:
                return env[slot]
            return ones if child == TRUE else zeros

        for nid, slot, cs, free_after in steps:
            n = nodes[nid]
            if n.op == OP_INPUT:
                name, bit = n.aux
                v = inputs[name][bit]
            elif n.op == OP_NOT:
                v = ~rd(cs[0], n.a)
            elif n.op == OP_AND:
                v = rd(cs[0], n.a) & rd(cs[1], n.b)
            elif n.op == OP_OR:
                v = rd(cs[0], n.a) | rd(cs[1], n.b)
            elif n.op == OP_XOR:
                v = rd(cs[0], n.a) ^ rd(cs[1], n.b)
            elif n.op == OP_ANDN:
                v = rd(cs[0], n.a) & ~rd(cs[1], n.b)
            elif n.op == OP_MUX:
                s, a, b = rd(cs[0], n.a), rd(cs[1], n.b), rd(cs[2], n.c)
                v = b ^ (s & (a ^ b))   # 3-op mux
            elif n.op == OP_LUT3:
                v = lut3(n.aux, rd(cs[0], n.a), rd(cs[1], n.b),
                         rd(cs[2], n.c), zeros)
            else:  # pragma: no cover
                raise ValueError(f"bad op {n.op}")
            for f in free_after:
                env[f] = None
            env[slot] = v
        out = {}
        for name, descs in out_wires.items():
            planes = [env[s] if kind == "slot" else (ones if s else zeros)
                      for kind, s in descs]
            shape = torch.broadcast_shapes(*(p.shape for p in planes))
            out[name] = torch.stack([p.expand(shape) for p in planes])
        return out

    _FN_CACHE[graph] = fn
    return fn


# ---------------------------------------------------------------------------
# Source emission (for inspection / documentation)
# ---------------------------------------------------------------------------
_OPFMT = {
    OP_NOT: "t{y} = ~{a}",
    OP_AND: "t{y} = {a} & {b}",
    OP_OR: "t{y} = {a} | {b}",
    OP_XOR: "t{y} = {a} ^ {b}",
    OP_ANDN: "t{y} = {a} & ~{b}",
    OP_MUX: "t{y} = ({a} & {b}) | (~{a} & {c})",
}


def emit_source(graph: Graph, name: str = "circuit") -> str:
    """Readable generated-code listing (one line per cell instance)."""
    lines = [f"def {name}(inputs):"]
    ref: dict[int, str] = {FALSE: "ZERO", TRUE: "ONES"}
    for nid in graph.topo_order():
        n = graph.nodes[nid]
        if n.op == OP_CONST:
            continue
        if n.op == OP_INPUT:
            nm, bit = n.aux
            ref[nid] = f"{nm}[{bit}]"
            continue
        args = {k: ref[getattr(n, k)] for k in ("a", "b", "c")
                if getattr(n, k) >= 0}
        if n.op == OP_LUT3:
            lines.append(f"    t{nid} = LUT{n.aux:03d}({args['a']}, "
                         f"{args['b']}, {args['c']})")
        else:
            lines.append("    " + _OPFMT[n.op].format(y=nid, **args))
        ref[nid] = f"t{nid}"
    for nm, bus in graph.outputs.items():
        lines.append(f"    {nm} = [" + ", ".join(ref[w] for w in bus) + "]")
    lines.append("    return {" + ", ".join(
        f"'{nm}': {nm}" for nm in graph.outputs) + "}")
    return "\n".join(lines)
