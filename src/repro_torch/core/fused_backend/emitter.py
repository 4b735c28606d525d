"""Netlist -> fused-kernel-body emitter.

``lower_netlist`` turns an optimized :class:`~repro_torch.core.circuit.Graph`
into a :class:`LoweredNetlist`, which is both

* **CUDA source** for the body of a fused kernel
  (:meth:`LoweredNetlist.cuda_body`): the ``_slot_schedule`` register
  allocation becomes a fixed-size file of ``uint32_t`` locals, every
  gate one straight-line C expression, and the whole body a
  ``static run(x, y, acc)`` that ``csrc/fused_mac.cuh`` inlines into its
  C loop.  The text is plain C over ``uint32_t``, so a host C++
  compiler builds it too (the CPU tests check it against
  ``eval_netlist`` that way); and
* a **plain torch body**: calling it with ``**{bus: planes}`` runs the
  same netlist with one torch op per gate, bit-identical to
  ``eval_netlist``.

The register file has a fixed size pinned at lowering time; a netlist
whose peak live-slot count exceeds an explicitly requested file raises
:class:`RegisterFileOverflow` before anything executes — the backend
fails loudly rather than spilling silently.

3-input LUT3 cells are emitted in algebraic normal form
(``codegen.lut3_anf``) as C expressions; ptxas folds each into one
``LOP3``.  Inline ``lop3.b32`` would need the truth table re-indexed:
the netlist numbers minterms ``a + 2b + 4c``, PTX's ``immLut``
``4a + 2b + c``.
"""
from __future__ import annotations

import weakref

from repro_torch.core.circuit import (OP_AND, OP_ANDN, OP_INPUT, OP_LUT3,
                                      OP_MUX, OP_NOT, OP_OR, OP_XOR, TRUE,
                                      Graph)
from repro_torch.core.codegen import _slot_schedule, lut3_anf, make_torch_fn


class RegisterFileOverflow(RuntimeError):
    """The netlist needs more live lane-word temporaries than the
    requested register file holds.  Raised at lowering time — the fused
    backend never spills and never truncates the file silently."""

    def __init__(self, need: int, have: int):
        self.need = need
        self.have = have
        super().__init__(
            f"netlist needs {need} register-file slots but the file "
            f"holds {have}; enlarge the file (or leave regfile_size "
            f"unset to size it from the schedule)")


def _lut3_expr(tt: int, a: str, b: str, c: str) -> str:
    negate, monos = lut3_anf(tt)
    ins = (a, b, c)
    terms = [" & ".join(ins[i] for i in range(3) if m & (1 << i))
             for m in monos]
    body = " ^ ".join(f"({t})" for t in terms) if terms else "0u"
    return f"~({body})" if negate else body


class LoweredNetlist:
    """A netlist lowered to a fused kernel body (see module docstring).

    ``nslots`` is the schedule's peak live-slot count and
    ``regfile_size`` the file the body declares.
    """

    def __init__(self, graph: Graph, steps, nslots: int, out_wires,
                 regfile_size: int):
        self.graph = graph
        self.steps = steps
        self.nslots = nslots
        self.out_wires = out_wires
        self.regfile_size = regfile_size
        self._gates = len(steps) - sum(
            1 for nid, *_ in steps if graph.nodes[nid].op == OP_INPUT)

    def __call__(self, **inputs):
        """The plain torch body: ``{bus: [width, ...lanes] int32}`` ->
        ``{bus: planes}``."""
        return make_torch_fn(self.graph)(**inputs)

    def gate_count(self) -> int:
        """Gates of the body, counted once at lowering: the chain-depth
        policy reads it on every launch."""
        return self._gates

    def cuda_body(self, name: str, **constants: int) -> str:
        """C++ source of ``struct name`` with ``static run(x, y, acc)``.

        Input bus ``x{j}`` bit ``b`` reads ``x[j*NIN + b]``, ``y{j}``
        likewise from ``y``, ``acc`` bit ``b`` reads ``acc[b]``; output
        bus ``out`` is written back to ``acc`` after every gate has run.
        ``constants`` become ``static constexpr int`` members beside
        ``NIN``, ``NOUT``, ``K`` and ``NSLOTS``.  The body expects the
        macro ``HF_INLINE`` (``__device__ __forceinline__`` in CUDA,
        ``inline`` on the host) and ``<cstdint>``.
        """
        g = self.graph
        k = sum(1 for bus in g.inputs if bus.startswith("x"))
        nin = len(g.inputs["x0"])
        nout = len(self.out_wires["out"])
        consts = {"NIN": nin, "NOUT": nout, "K": k,
                  "NSLOTS": self.regfile_size, **constants}
        lines = [f"struct {name} {{"]
        lines += [f"  static constexpr int {key} = {val};"
                  for key, val in consts.items()]
        lines.append("  static HF_INLINE void run(const uint32_t* __restrict__"
                     " x, const uint32_t* __restrict__ y, uint32_t* "
                     "__restrict__ acc) {")
        regs = [f"r{i}" for i in range(self.regfile_size)]
        for i in range(0, len(regs), 16):
            lines.append("    uint32_t " + ", ".join(regs[i:i + 16]) + ";")
        nodes = g.nodes

        def rd(slot, child):
            if slot >= 0:
                return f"r{slot}"
            return "~0u" if child == TRUE else "0u"

        for nid, slot, cs, _ in self.steps:
            n = nodes[nid]
            if n.op == OP_INPUT:
                bus, bit = n.aux
                if bus == "acc":
                    v = f"acc[{bit}]"
                else:
                    v = f"{bus[0]}[{int(bus[1:]) * nin + bit}]"
            elif n.op == OP_NOT:
                v = f"~{rd(cs[0], n.a)}"
            elif n.op == OP_AND:
                v = f"{rd(cs[0], n.a)} & {rd(cs[1], n.b)}"
            elif n.op == OP_OR:
                v = f"{rd(cs[0], n.a)} | {rd(cs[1], n.b)}"
            elif n.op == OP_XOR:
                v = f"{rd(cs[0], n.a)} ^ {rd(cs[1], n.b)}"
            elif n.op == OP_ANDN:
                v = f"{rd(cs[0], n.a)} & ~{rd(cs[1], n.b)}"
            elif n.op == OP_MUX:
                s, a, b = rd(cs[0], n.a), rd(cs[1], n.b), rd(cs[2], n.c)
                v = f"{b} ^ ({s} & ({a} ^ {b}))"
            elif n.op == OP_LUT3:
                v = _lut3_expr(n.aux, rd(cs[0], n.a), rd(cs[1], n.b),
                               rd(cs[2], n.c))
            else:  # pragma: no cover
                raise ValueError(f"bad op {n.op}")
            lines.append(f"    r{slot} = {v};")
        for bit, (kind, s) in enumerate(self.out_wires["out"]):
            v = f"r{s}" if kind == "slot" else ("~0u" if s else "0u")
            lines.append(f"    acc[{bit}] = {v};")
        lines += ["  }", "};", ""]
        return "\n".join(lines)


# One lowering per (graph, file size) — repeated launches of the same
# netlist reuse the schedule instead of re-allocating.
_LOWER_CACHE: "weakref.WeakKeyDictionary[Graph, dict]" = \
    weakref.WeakKeyDictionary()


def lower_netlist(graph: Graph, *,
                  regfile_size: int | None = None) -> LoweredNetlist:
    """Lower ``graph`` to a fused kernel body.

    ``regfile_size`` pins the register file; ``None`` sizes it from the
    schedule's peak live-slot count.  An explicit size smaller than the
    peak raises :class:`RegisterFileOverflow` immediately.
    """
    per_graph = _LOWER_CACHE.setdefault(graph, {})
    cached = per_graph.get(regfile_size)
    if cached is not None:
        return cached
    steps, nslots, out_wires = _slot_schedule(graph)
    size = nslots if regfile_size is None else regfile_size
    if nslots > size:
        raise RegisterFileOverflow(nslots, size)
    lowered = LoweredNetlist(graph, steps, nslots, out_wires, size)
    per_graph[regfile_size] = lowered
    return lowered
