"""Netlist -> fused-kernel-body emitter.

``lower_netlist`` turns an optimized :class:`~repro_torch.core.circuit.Graph`
into a :class:`LoweredNetlist`, which is both

* **CUDA source** for the body of a fused kernel
  (:meth:`LoweredNetlist.cuda_body`): the ``_slot_schedule`` register
  allocation becomes a fixed-size file of ``uint32_t`` locals, every
  gate one ``HF_LOP3`` — one ``lop3.b32`` with the gate's truth table in
  ``csrc/fused_mac.cuh``, a plain C function elsewhere — and the whole
  body a ``static run(...)`` that the kernel inlines into its C loop.
  The text is plain C over ``uint32_t``, so a host C++ compiler builds
  it too (the CPU tests check it against ``eval_netlist`` that way); and
* a **plain torch body**: calling it with ``**{bus: planes}`` runs the
  same netlist with one torch op per gate, bit-identical to
  ``eval_netlist``.

The register file has a fixed size pinned at lowering time; a netlist
whose peak live-slot count exceeds an explicitly requested file raises
:class:`RegisterFileOverflow` before anything executes — the backend
fails loudly rather than spilling silently.

Every gate, 3-input LUT3 cells included, becomes one ``LOP3``: left
to fold C expressions, ptxas spent 1026 ``LOP3`` on the 722 gates of
hobflops9's 2-step chain (``scripts/torch_fused_probe.py``).  The
netlist numbers a LUT3's minterms ``a + 2b + 4c``, PTX's ``immLut``
``4a + 2b + c``; :func:`lop3_imm` re-indexes.
"""
from __future__ import annotations

import weakref

from repro_torch.core.circuit import (OP_AND, OP_ANDN, OP_INPUT, OP_LUT3,
                                      OP_MUX, OP_NOT, OP_OR, OP_XOR, TRUE,
                                      Graph)
from repro_torch.core.codegen import _slot_schedule, make_torch_fn

# The C fallback of HF_LOP3 for a host compiler; csrc/fused_mac.cuh
# defines HF_LOP3 as one lop3.b32 before any body.
_HOST_LOP3 = """#ifndef HF_LOP3
#define HF_LOP3(a, b, c, imm) hf_lop3_c((a), (b), (c), (imm))
static inline uint32_t hf_lop3_c(uint32_t a, uint32_t b, uint32_t c,
                                 uint32_t imm) {
  uint32_t r = 0;
  for (int i = 0; i < 8; ++i)
    if ((imm >> i) & 1u)
      r |= ((i & 4) ? a : ~a) & ((i & 2) ? b : ~b) & ((i & 1) ? c : ~c);
  return r;
}
#endif"""

# Truth tables of the 2-input ops over (a, b) = PTX's (0xF0, 0xCC).
_OP_IMM = {OP_AND: 0xF0 & 0xCC, OP_OR: 0xF0 | 0xCC, OP_XOR: 0xF0 ^ 0xCC,
           OP_ANDN: 0xF0 & ~0xCC & 0xFF, OP_NOT: ~0xF0 & 0xFF}


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


def lop3_imm(tt: int) -> int:
    """PTX ``immLut`` of a LUT3 whose truth table ``tt`` has bit
    ``a + 2b + 4c`` set where it is true (``lop3.b32 d, a, b, c``)."""
    return sum(1 << i for i in range(8)
               if tt >> (((i >> 2) & 1) | (i & 2) | ((i & 1) << 2)) & 1)


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
        """C++ source of ``struct name`` with a ``static run(...)``.

        Each input bus family ``x0, x1, ...`` (one letter and an index)
        is read through a pointer of that letter: bit ``b`` of bus
        ``x{j}`` is ``x[j * width + b]``.  The pointers are the
        families' letters in order, then ``acc``: ``run(x, y, acc)`` for
        the MAC chain and the multiplier, ``run(p, acc)`` for the
        add-only chain.  Input bus ``acc`` bit ``b`` reads ``acc[b]``;
        output bus ``out`` is written to ``acc`` after every gate has
        run.  ``constants`` become ``static constexpr int`` members
        beside ``NIN`` (the first family's width), ``NOUT``, ``K`` (its
        bus count) and ``NSLOTS``.  The body expects the macro
        ``HF_INLINE`` (``__device__ __forceinline__`` in CUDA,
        ``inline`` on the host) and ``<cstdint>``; ``HF_LOP3`` falls
        back to plain C where the includer has not defined it.
        """
        g = self.graph
        families = sorted({bus[0] for bus in g.inputs if bus != "acc"})
        width = {f: len(g.inputs[f"{f}0"]) for f in families}
        k = sum(1 for bus in g.inputs if bus[0] == families[0]
                and bus != "acc")
        nout = len(self.out_wires["out"])
        consts = {"NIN": width[families[0]], "NOUT": nout, "K": k,
                  "NSLOTS": self.regfile_size, **constants}
        lines = [_HOST_LOP3, f"struct {name} {{"]
        lines += [f"  static constexpr int {key} = {val};"
                  for key, val in consts.items()]
        params = ", ".join(f"const uint32_t* __restrict__ {f}"
                           for f in families)
        lines.append(f"  static HF_INLINE void run({params}, uint32_t* "
                     f"__restrict__ acc) {{")
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
                    v = f"{bus[0]}[{int(bus[1:]) * width[bus[0]] + bit}]"
            elif n.op in _OP_IMM:
                a_ = rd(cs[0], n.a)
                b_ = a_ if n.op == OP_NOT else rd(cs[1], n.b)
                v = f"HF_LOP3({a_}, {b_}, {a_}, 0x{_OP_IMM[n.op]:02x})"
            elif n.op == OP_MUX:
                # s ? a : b over (s, a, b) = (0xF0, 0xCC, 0xAA)
                imm = (0xF0 & 0xCC) | (~0xF0 & 0xAA & 0xFF)
                v = (f"HF_LOP3({rd(cs[0], n.a)}, {rd(cs[1], n.b)}, "
                     f"{rd(cs[2], n.c)}, 0x{imm:02x})")
            elif n.op == OP_LUT3:
                v = (f"HF_LOP3({rd(cs[0], n.a)}, {rd(cs[1], n.b)}, "
                     f"{rd(cs[2], n.c)}, 0x{lop3_imm(n.aux):02x})")
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
