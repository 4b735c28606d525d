"""Gate-level combinational circuit IR with structural hashing.

This module is the in-repo replacement for the paper's FloPoCo -> Cadence
Genus -> Yosys/ABC hardware flow.  Circuits are built as DAGs of 1-bit
logic gates; every gate construction goes through a hash-consing +
constant-folding layer so the graph is kept canonical while it is built
(the software analogue of Genus' area optimization + ABC ``strash``).

A node is identified by an integer id.  Node 0 is constant FALSE and node
1 is constant TRUE.  Buses (multi-bit values) are plain Python lists of
node ids, least-significant bit first.

The IR deliberately mirrors the gate vocabulary of the paper's standard
cell libraries (Table 1): 2-input AND/OR/XOR/ANDN, NOT, the 3-input Arm
Neon SEL (mux), and the AVX512 ternary LUT3.  Construction only ever
emits {NOT, AND, OR, XOR, MUX}; technology mapping (``repro.core.opt``)
re-expresses the graph in terms of a chosen cell library.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

# Op codes -----------------------------------------------------------------
OP_CONST = 0   # aux = 0 or 1
OP_INPUT = 1   # aux = (name, bit_index)
OP_NOT = 2     # a
OP_AND = 3     # a, b
OP_OR = 4      # a, b
OP_XOR = 5     # a, b
OP_ANDN = 6    # a & ~b        (introduced by tech mapping only)
OP_MUX = 7     # s ? a : b     (s=a_field, a=b_field, b=c_field)
OP_LUT3 = 8    # aux = 8-bit truth table over (a, b, c); y = tt[(c<<2)|(b<<1)|a]

OP_NAMES = {
    OP_CONST: "CONST",
    OP_INPUT: "INPUT",
    OP_NOT: "NOT",
    OP_AND: "AND",
    OP_OR: "OR",
    OP_XOR: "XOR",
    OP_ANDN: "ANDN",
    OP_MUX: "MUX",
    OP_LUT3: "LUT3",
}

FALSE = 0
TRUE = 1


@dataclasses.dataclass
class Node:
    op: int
    a: int = -1
    b: int = -1
    c: int = -1
    aux: object = None


class Graph:
    """A combinational circuit under construction.

    Hash-consing guarantees that structurally identical gates share a
    node id, and the constructor helpers apply local boolean
    simplifications (idempotence, annihilation, involution, etc.) so the
    graph never contains the trivially redundant logic a naive netlist
    writer would produce.
    """

    def __init__(self) -> None:
        self.nodes: list[Node] = [Node(OP_CONST, aux=0), Node(OP_CONST, aux=1)]
        self._cse: dict[tuple, int] = {}
        self._not_of: dict[int, int] = {}  # id -> id of its registered inverse
        self.inputs: dict[str, list[int]] = {}   # name -> bus (LSB first)
        self.outputs: dict[str, list[int]] = {}  # name -> bus (LSB first)

    # -- raw node creation --------------------------------------------------
    def _new(self, op: int, a: int = -1, b: int = -1, c: int = -1, aux=None) -> int:
        key = (op, a, b, c, aux)
        hit = self._cse.get(key)
        if hit is not None:
            return hit
        self.nodes.append(Node(op, a, b, c, aux))
        nid = len(self.nodes) - 1
        self._cse[key] = nid
        return nid

    # -- inputs / outputs ---------------------------------------------------
    def input_bus(self, name: str, width: int) -> list[int]:
        if name in self.inputs:
            raise ValueError(f"duplicate input bus {name!r}")
        bus = [self._new(OP_INPUT, aux=(name, i)) for i in range(width)]
        self.inputs[name] = bus
        return bus

    def output_bus(self, name: str, bus: Sequence[int]) -> None:
        if name in self.outputs:
            raise ValueError(f"duplicate output bus {name!r}")
        self.outputs[name] = list(bus)

    # -- logic constructors (with folding) ------------------------------------
    def NOT(self, a: int) -> int:
        if a == FALSE:
            return TRUE
        if a == TRUE:
            return FALSE
        n = self.nodes[a]
        if n.op == OP_NOT:
            return n.a
        hit = self._not_of.get(a)
        if hit is not None:
            return hit
        nid = self._new(OP_NOT, a)
        self._not_of[a] = nid
        self._not_of[nid] = a
        return nid

    def _is_compl(self, a: int, b: int) -> bool:
        return self._not_of.get(a) == b

    def AND(self, a: int, b: int) -> int:
        if a > b:
            a, b = b, a
        if a == FALSE:
            return FALSE
        if a == TRUE:
            return b
        if a == b:
            return a
        if self._is_compl(a, b):
            return FALSE
        return self._new(OP_AND, a, b)

    def OR(self, a: int, b: int) -> int:
        if a > b:
            a, b = b, a
        if a == TRUE:
            return TRUE
        if a == FALSE:
            return b
        if a == b:
            return a
        if self._is_compl(a, b):
            return TRUE
        return self._new(OP_OR, a, b)

    def XOR(self, a: int, b: int) -> int:
        if a > b:
            a, b = b, a
        if a == FALSE:
            return b
        if a == TRUE:
            return self.NOT(b)
        if a == b:
            return FALSE
        if self._is_compl(a, b):
            return TRUE
        return self._new(OP_XOR, a, b)

    def XNOR(self, a: int, b: int) -> int:
        return self.NOT(self.XOR(a, b))

    def NAND(self, a: int, b: int) -> int:
        return self.NOT(self.AND(a, b))

    def NOR(self, a: int, b: int) -> int:
        return self.NOT(self.OR(a, b))

    def MUX(self, s: int, a: int, b: int) -> int:
        """s ? a : b."""
        if s == TRUE:
            return a
        if s == FALSE:
            return b
        if a == b:
            return a
        if a == TRUE and b == FALSE:
            return s
        if a == FALSE and b == TRUE:
            return self.NOT(s)
        if a == s:          # s ? s : b  == s | b... only when a==s -> s?1:b
            a = TRUE
            return self.OR(s, b)
        if b == s:          # s ? a : s  == s & a
            return self.AND(s, a)
        if self._is_compl(s, a):   # s ? ~s : b == ~s & b
            return self.AND(self.NOT(s), b)
        if self._is_compl(s, b):   # s ? a : ~s == ~s | a... s?a:1 when s=0 -> 1
            return self.OR(self.NOT(s), a)
        if a == FALSE:      # s ? 0 : b == ~s & b
            return self.AND(self.NOT(s), b)
        if a == TRUE:       # s ? 1 : b == s | b
            return self.OR(s, b)
        if b == FALSE:      # s ? a : 0 == s & a
            return self.AND(s, a)
        if b == TRUE:       # s ? a : 1 == ~s | a
            return self.OR(self.NOT(s), a)
        if self._is_compl(a, b):   # s ? a : ~a == s XNOR a? check: s=1->a, s=0->~a == ~(s^~a)= s xnor a
            return self.XNOR(s, a)
        return self._new(OP_MUX, s, a, b)

    # Tech-mapping constructors (used by repro.core.opt only) ----------------
    def ANDN(self, a: int, b: int) -> int:
        """a & ~b."""
        if a == FALSE or b == TRUE:
            return FALSE
        if b == FALSE:
            return a
        if a == b:
            return FALSE
        if a == TRUE:
            return self.NOT(b)
        if self._is_compl(a, b):
            return a
        return self._new(OP_ANDN, a, b)

    def LUT3(self, tt: int, a: int, b: int, c: int) -> int:
        """Arbitrary 3-input boolean function, AVX512-ternary style.

        ``tt`` is the 8-bit truth table: output for input pattern
        (c, b, a) is bit ``(c << 2) | (b << 1) | a`` of ``tt``.
        """
        assert 0 <= tt < 256
        if tt == 0:
            return FALSE
        if tt == 255:
            return TRUE
        return self._new(OP_LUT3, a, b, c, aux=tt)

    # -- analysis -------------------------------------------------------------
    def topo_order(self, roots: Iterable[int] | None = None) -> list[int]:
        """Topologically sorted live node ids (inputs/consts included)."""
        if roots is None:
            roots = [w for bus in self.outputs.values() for w in bus]
        seen: set[int] = set()
        order: list[int] = []
        stack: list[tuple[int, bool]] = [(r, False) for r in roots]
        while stack:
            nid, expanded = stack.pop()
            if expanded:
                order.append(nid)
                continue
            if nid in seen:
                continue
            seen.add(nid)
            stack.append((nid, True))
            n = self.nodes[nid]
            for child in (n.a, n.b, n.c):
                if child >= 0 and child not in seen:
                    stack.append((child, False))
        return order

    def live_gate_count(self, ops: Iterable[int] | None = None) -> int:
        """Number of live logic gates (excludes inputs and constants)."""
        logic = set(ops) if ops is not None else {
            OP_NOT, OP_AND, OP_OR, OP_XOR, OP_ANDN, OP_MUX, OP_LUT3}
        return sum(1 for nid in self.topo_order()
                   if self.nodes[nid].op in logic)

    def op_histogram(self) -> dict[str, int]:
        hist: dict[str, int] = {}
        for nid in self.topo_order():
            name = OP_NAMES[self.nodes[nid].op]
            hist[name] = hist.get(name, 0) + 1
        hist.pop("CONST", None)
        hist.pop("INPUT", None)
        return hist

    def depth(self) -> int:
        """Longest combinational path, in gates."""
        d: dict[int, int] = {}
        for nid in self.topo_order():
            n = self.nodes[nid]
            if n.op in (OP_CONST, OP_INPUT):
                d[nid] = 0
            else:
                d[nid] = 1 + max(d.get(ch, 0) for ch in (n.a, n.b, n.c) if ch >= 0)
        return max(d.values(), default=0)

    def stats(self) -> dict:
        return {
            "gates": self.live_gate_count(),
            "depth": self.depth(),
            "histogram": self.op_histogram(),
            "inputs": {k: len(v) for k, v in self.inputs.items()},
            "outputs": {k: len(v) for k, v in self.outputs.items()},
        }
