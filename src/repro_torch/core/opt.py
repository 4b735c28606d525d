"""Netlist optimization + technology mapping (the Genus/ABC analogue).

The paper feeds FloPoCo VHDL through Cadence Genus + Yosys/ABC with
custom Liberty cell libraries matching each ISA's bitwise instructions
(Table 1).  Here the same role is played by a priority-cuts, area-flow
technology mapper over the circuit IR:

* ``LIB_AVX2``   — 2-input AND/OR/XOR/ANDN + NOT (x86 SIMD bitwise ops)
* ``LIB_NEON``   — 2-input AND/OR/XOR/ORN + NOT + 3-input SEL (mux)
* ``LIB_AVX512`` — every 3-input boolean function (ternary-LUT imm8)
* ``LIB_TPU_VPU``— 2-input AND/OR/XOR + NOT: what XLA exposes as single
                   elementwise HLO bitwise ops on the TPU vector unit.
                   (TPUs have no ternary bitwise instruction; the paper's
                   AVX512 trick does not transfer — see DESIGN.md.)

Mapping is semantics-preserving; tests re-verify mapped netlists against
the originals (the analogue of the paper's Yosys SAT check).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

from .circuit import (FALSE, OP_AND, OP_ANDN, OP_CONST, OP_INPUT, OP_LUT3,
                      OP_MUX, OP_NOT, OP_OR, OP_XOR, TRUE, Graph)

_MAX_CUTS = 10  # priority cuts kept per node


def _tt_for(nvars: int, var: int) -> int:
    """Truth table (2^nvars bits) of projection onto variable `var`."""
    pat = 0
    for m in range(1 << nvars):
        if (m >> var) & 1:
            pat |= 1 << m
    return pat


def _mask(nvars: int) -> int:
    return (1 << (1 << nvars)) - 1


@dataclasses.dataclass(frozen=True)
class CellLib:
    name: str
    k: int                                   # max cut size
    tts: dict[tuple[int, int], str]          # (nvars, tt) -> cell name

    def supports(self, nvars: int, tt: int) -> str | None:
        return self.tts.get((nvars, tt))


def _two_input_tts(cells: dict[str, Callable[[int, int], int]]):
    """Build (nvars=2, tt) table from python bitwise lambdas over a,b."""
    out: dict[tuple[int, int], str] = {}
    a, b = _tt_for(2, 0), _tt_for(2, 1)
    m = _mask(2)
    for name, fn in cells.items():
        out[(2, fn(a, b) & m)] = name
        out.setdefault((2, fn(b, a) & m), name)  # commuted operand order
    return out


def _base_tts() -> dict[tuple[int, int], str]:
    tts = _two_input_tts({
        "AND2": lambda a, b: a & b,
        "OR2": lambda a, b: a | b,
        "XOR2": lambda a, b: a ^ b,
    })
    tts[(1, 0b01)] = "NOT"
    return tts


def make_lib_avx2() -> CellLib:
    tts = _base_tts()
    tts.update(_two_input_tts({"ANDN2": lambda a, b: a & ~b}))
    return CellLib("avx2", 2, tts)


def make_lib_tpu() -> CellLib:
    return CellLib("tpu_vpu", 2, _base_tts())


def make_lib_neon() -> CellLib:
    tts = _base_tts()
    tts.update(_two_input_tts({"ORN2": lambda a, b: a | ~b}))
    # SEL: s ? a : b over every assignment of the 3 cut leaves.
    s_, a_, b_ = (_tt_for(3, i) for i in range(3))
    m = _mask(3)
    for perm in itertools.permutations((0, 1, 2)):
        vs = [_tt_for(3, p) for p in perm]
        tt = ((vs[0] & vs[1]) | (~vs[0] & vs[2])) & m
        tts.setdefault((3, tt), "SEL")
    return CellLib("neon", 3, tts)


def make_lib_avx512() -> CellLib:
    tts = _base_tts()
    for tt in range(256):
        tts.setdefault((3, tt), f"LUT{tt:03d}")
    # 2-input ternary ops are also single vpternlog instructions
    for tt in range(16):
        tts.setdefault((2, tt), f"LUT2_{tt:02d}")
    return CellLib("avx512", 3, tts)


CELL_LIBS: dict[str, Callable[[], CellLib]] = {
    "avx2": make_lib_avx2,
    "neon": make_lib_neon,
    "avx512": make_lib_avx512,
    "tpu_vpu": make_lib_tpu,
}


# ---------------------------------------------------------------------------
# MUX / LUT3 decomposition (pre-pass so every node is 1-2 input)
# ---------------------------------------------------------------------------
def decompose(graph: Graph) -> Graph:
    """Rewrite MUX/LUT3/ANDN into {NOT, AND, OR, XOR} form."""
    g2 = Graph()
    remap: dict[int, int] = {FALSE: FALSE, TRUE: TRUE}
    for nid in graph.topo_order():
        n = graph.nodes[nid]
        if nid in (FALSE, TRUE):
            continue
        if n.op == OP_INPUT:
            name, bit = n.aux
            if name not in g2.inputs:
                g2.input_bus(name, len(graph.inputs[name]))
            remap[nid] = g2.inputs[name][bit]
        elif n.op == OP_NOT:
            remap[nid] = g2.NOT(remap[n.a])
        elif n.op == OP_AND:
            remap[nid] = g2.AND(remap[n.a], remap[n.b])
        elif n.op == OP_OR:
            remap[nid] = g2.OR(remap[n.a], remap[n.b])
        elif n.op == OP_XOR:
            remap[nid] = g2.XOR(remap[n.a], remap[n.b])
        elif n.op == OP_ANDN:
            remap[nid] = g2.AND(remap[n.a], g2.NOT(remap[n.b]))
        elif n.op == OP_MUX:
            # 3-gate form: b ^ (s & (a ^ b)) — optimal for 2-input libs,
            # and 3-cut recovery still re-derives SEL/LUT3 from it.
            s, a, b = remap[n.a], remap[n.b], remap[n.c]
            remap[nid] = g2.XOR(b, g2.AND(s, g2.XOR(a, b)))
        elif n.op == OP_LUT3:
            a, b, c = remap[n.a], remap[n.b], remap[n.c]
            acc = FALSE
            for m in range(8):
                if (n.aux >> m) & 1:
                    t = a if m & 1 else g2.NOT(a)
                    t = g2.AND(t, b if m & 2 else g2.NOT(b))
                    t = g2.AND(t, c if m & 4 else g2.NOT(c))
                    acc = g2.OR(acc, t)
            remap[nid] = acc
        else:  # pragma: no cover
            raise ValueError(n.op)
    # make sure unreferenced input buses survive
    for name, bus in graph.inputs.items():
        if name not in g2.inputs:
            g2.input_bus(name, len(bus))
    for name, bus in graph.outputs.items():
        g2.output_bus(name, [remap[w] for w in bus])
    return g2


# ---------------------------------------------------------------------------
# Priority-cuts area-flow mapper
# ---------------------------------------------------------------------------
def _cut_tt(graph: Graph, node: int, cut: tuple[int, ...]) -> int:
    """Truth table of `node` as a function of the cut leaves."""
    nvars = len(cut)
    assign = {leaf: _tt_for(nvars, i) for i, leaf in enumerate(cut)}
    m = _mask(nvars)
    memo: dict[int, int] = dict(assign)
    memo[FALSE] = 0
    memo[TRUE] = m

    def ev(x: int) -> int:
        v = memo.get(x)
        if v is not None:
            return v
        n = graph.nodes[x]
        if n.op == OP_NOT:
            v = ~ev(n.a) & m
        elif n.op == OP_AND:
            v = ev(n.a) & ev(n.b)
        elif n.op == OP_OR:
            v = ev(n.a) | ev(n.b)
        elif n.op == OP_XOR:
            v = ev(n.a) ^ ev(n.b)
        else:  # pragma: no cover
            raise ValueError(f"unmapped-op {n.op} reached tt eval")
        memo[x] = v
        return v

    return ev(node)


def tech_map(graph: Graph, lib: CellLib) -> Graph:
    """Map onto `lib`, minimizing mapped cell count (area flow heuristic)."""
    g = decompose(graph)
    order = g.topo_order()
    nodes = g.nodes

    fanout: dict[int, int] = {}
    for nid in order:
        n = nodes[nid]
        for ch in (n.a, n.b):
            if ch >= 0:
                fanout[ch] = fanout.get(ch, 0) + 1

    is_leaf = {nid for nid in order
               if nodes[nid].op in (OP_INPUT, OP_CONST)}

    cuts: dict[int, list[tuple[int, ...]]] = {}
    best: dict[int, tuple[tuple[int, ...], float]] = {}  # node -> (cut, flow)

    def flow_of(cut: tuple[int, ...]) -> float:
        f = 1.0
        for leaf in cut:
            if leaf in is_leaf:
                continue
            f += best[leaf][1] / max(1, fanout.get(leaf, 1))
        return f

    for nid in order:
        if nid in is_leaf or nid in (FALSE, TRUE):
            cuts[nid] = [(nid,)]
            continue
        n = nodes[nid]
        children = [c for c in (n.a, n.b) if c >= 0]
        cand: set[tuple[int, ...]] = set()
        if len(children) == 1:
            for c1 in cuts[children[0]]:
                if len(c1) <= lib.k:
                    cand.add(tuple(sorted(c1)))
        else:
            for c1 in cuts[children[0]]:
                for c2 in cuts[children[1]]:
                    u = tuple(sorted(set(c1) | set(c2)))
                    if len(u) <= lib.k:
                        cand.add(u)
        # score every cut; only library-implementable ones are choosable,
        # but all survive enumeration so parents can build larger cuts.
        scored, choosable = [], []
        for cut in cand:
            tt = _cut_tt(g, nid, cut)
            fl = flow_of(cut)
            scored.append((fl, cut))
            if lib.supports(len(cut), tt) is not None:
                choosable.append((fl, cut))
        if not choosable:
            # trivial cut fallback: direct children, native op cost 1
            cut = tuple(sorted(children))
            choosable = [(flow_of(cut), cut)]
        choosable.sort(key=lambda t: (t[0], len(t[1])))
        best[nid] = (choosable[0][1], choosable[0][0])
        scored.sort(key=lambda t: (t[0], len(t[1])))
        keep = [c for _, c in scored[:_MAX_CUTS]]
        cuts[nid] = keep + [(nid,)]

    # ---- cover extraction -------------------------------------------------
    g2 = Graph()
    new_id: dict[int, int] = {FALSE: FALSE, TRUE: TRUE}
    for name, bus in g.inputs.items():
        nb = g2.input_bus(name, len(bus))
        for old, new in zip(bus, nb):
            new_id[old] = new

    def emit(nid: int) -> int:
        if nid in new_id:
            return new_id[nid]
        n = nodes[nid]
        cut, _ = best[nid]
        tt = _cut_tt(g, nid, cut)
        cell = lib.supports(len(cut), tt)
        leaves = [emit(leaf) for leaf in cut]
        if cell is None:
            # native-op fallback over direct children
            kids = [emit(c) for c in (n.a, n.b) if c >= 0]
            out = {OP_NOT: lambda: g2.NOT(kids[0]),
                   OP_AND: lambda: g2.AND(*kids),
                   OP_OR: lambda: g2.OR(*kids),
                   OP_XOR: lambda: g2.XOR(*kids)}[n.op]()
        else:
            out = _emit_cell(g2, cell, tt, leaves)
        new_id[nid] = out
        return out

    for name, bus in g.outputs.items():
        g2.output_bus(name, [emit(w) for w in bus])
    return g2


def _emit_cell(g2: Graph, cell: str, tt: int, leaves: list[int]) -> int:
    la = leaves + [FALSE] * (3 - len(leaves))
    if cell == "NOT":
        return g2.NOT(leaves[0])
    if cell == "AND2":
        return _emit2(g2, tt, la, lambda a, b: g2.AND(a, b),
                      lambda a, b: a & b)
    if cell == "OR2":
        return _emit2(g2, tt, la, lambda a, b: g2.OR(a, b),
                      lambda a, b: a | b)
    if cell == "XOR2":
        return _emit2(g2, tt, la, lambda a, b: g2.XOR(a, b),
                      lambda a, b: a ^ b)
    if cell == "ANDN2":
        return _emit2(g2, tt, la, lambda a, b: g2.ANDN(a, b),
                      lambda a, b: a & ~b)
    if cell == "ORN2":
        # a | ~b  ==  NOT(ANDN(b, a)); represent as OR(a, NOT b) which the
        # evaluator costs as one cell via the ORN histogram rewrite... keep
        # it simple and canonical: emit OR(a, NOT(b)) — counted as ORN by
        # the histogram pass below.
        return _emit2(g2, tt, la, lambda a, b: g2.OR(a, g2.NOT(b)),
                      lambda a, b: a | (~b & _mask(2)))
    if cell == "SEL":
        # find the permutation realizing tt as mux(s, a, b)
        for perm in itertools.permutations(range(3)):
            vs = [_tt_for(3, p) for p in perm]
            m = _mask(3)
            if ((vs[0] & vs[1]) | (~vs[0] & vs[2])) & m == tt:
                return g2.MUX(la[perm[0]], la[perm[1]], la[perm[2]])
        raise AssertionError("SEL tt not realizable")
    if cell.startswith("LUT2_"):
        # 2-input ternary LUT: widen tt(2 vars) to tt(3 vars) ignoring c
        tt3 = 0
        for m in range(8):
            if (tt >> (m & 3)) & 1:
                tt3 |= 1 << m
        return g2.LUT3(tt3, la[0], la[1], la[2])
    if cell.startswith("LUT"):
        return g2.LUT3(tt, la[0], la[1], la[2])
    raise AssertionError(cell)


def _emit2(g2, tt, leaves, build, fn):
    m = _mask(2)
    a, b = _tt_for(2, 0), _tt_for(2, 1)
    if fn(a, b) & m == tt:
        return build(leaves[0], leaves[1])
    return build(leaves[1], leaves[0])


# ---------------------------------------------------------------------------
# Post-mapping netlist optimization passes (the ABC clean-up analogue)
# ---------------------------------------------------------------------------
def _lut3_fold(g2: Graph, tt: int, ins: list[int]) -> int:
    """Emit a 3-input function, specializing constants / duplicate /
    complementary inputs down to 2-input gates where possible."""
    # Reduce: substitute constants and merge duplicate/complement inputs.
    live: list[int] = []        # distinct non-constant inputs, in order
    pol: list[tuple[int, int]] = []  # per original var: (live index, invert)
    for w in ins:
        if w == FALSE or w == TRUE:
            pol.append((-1, 1 if w == TRUE else 0))
            continue
        hit = None
        for j, u in enumerate(live):
            if u == w:
                hit = (j, 0)
                break
            if g2._is_compl(u, w):
                hit = (j, 1)
                break
        if hit is None:
            live.append(w)
            hit = (len(live) - 1, 0)
        pol.append(hit)
    nv = len(live)
    # Re-express tt over the live variables.
    tt2 = 0
    for m in range(1 << nv):
        idx = 0
        for i, (j, inv) in enumerate(pol):
            bit = inv if j < 0 else ((m >> j) & 1) ^ inv
            idx |= bit << i
        if (tt >> idx) & 1:
            tt2 |= 1 << m
    if nv == 0:
        return TRUE if tt2 & 1 else FALSE
    if nv == 1:
        u = live[0]
        return {0b00: FALSE, 0b01: g2.NOT(u), 0b10: u, 0b11: TRUE}[tt2 & 3]
    if nv == 2:
        return _emit_tt2(g2, tt2 & 0xF, live[0], live[1])
    if tt2 == 0:
        return FALSE
    if tt2 == 0xFF:
        return TRUE
    return g2.LUT3(tt2, live[0], live[1], live[2])


def _emit_tt2(g2: Graph, tt2: int, u: int, v: int) -> int:
    """Any 2-variable function as <=2 two-input gates (bit m = f(v,u)
    at index (v<<1)|u)."""
    table = {
        0b0000: lambda: FALSE,          0b1111: lambda: TRUE,
        0b1010: lambda: u,              0b1100: lambda: v,
        0b0101: lambda: g2.NOT(u),      0b0011: lambda: g2.NOT(v),
        0b1000: lambda: g2.AND(u, v),   0b1110: lambda: g2.OR(u, v),
        0b0110: lambda: g2.XOR(u, v),   0b1001: lambda: g2.XNOR(u, v),
        0b0111: lambda: g2.NAND(u, v),  0b0001: lambda: g2.NOR(u, v),
        0b0010: lambda: g2.ANDN(u, v),  0b0100: lambda: g2.ANDN(v, u),
        0b1011: lambda: g2.OR(u, g2.NOT(v)),
        0b1101: lambda: g2.OR(v, g2.NOT(u)),
    }
    return table[tt2]()


def _rebuild(graph: Graph, andn_fanout1: set[int] | None = None) -> Graph:
    """Rebuild the live cone through the folding constructors.

    This is simultaneously a constant-propagation pass (the constructors
    fold constant / duplicate / complementary operands; LUT3 truth
    tables are specialized explicitly) and a dead-node sweep (only the
    output cone is visited).  When ``andn_fanout1`` is given, AND nodes
    whose NOT-child id is in the set are re-emitted as fused ANDN cells.
    """
    g2 = Graph()
    remap: dict[int, int] = {FALSE: FALSE, TRUE: TRUE}
    for nid in graph.topo_order():
        n = graph.nodes[nid]
        if nid in (FALSE, TRUE):
            continue
        if n.op == OP_INPUT:
            name, bit = n.aux
            if name not in g2.inputs:
                g2.input_bus(name, len(graph.inputs[name]))
            remap[nid] = g2.inputs[name][bit]
        elif n.op == OP_CONST:
            remap[nid] = TRUE if n.aux else FALSE
        elif n.op == OP_NOT:
            remap[nid] = g2.NOT(remap[n.a])
        elif n.op == OP_AND:
            done = False
            if andn_fanout1:
                for x, y in ((n.a, n.b), (n.b, n.a)):
                    if y in andn_fanout1 and graph.nodes[y].op == OP_NOT:
                        remap[nid] = g2.ANDN(remap[x],
                                             remap[graph.nodes[y].a])
                        done = True
                        break
            if not done:
                remap[nid] = g2.AND(remap[n.a], remap[n.b])
        elif n.op == OP_OR:
            remap[nid] = g2.OR(remap[n.a], remap[n.b])
        elif n.op == OP_XOR:
            remap[nid] = g2.XOR(remap[n.a], remap[n.b])
        elif n.op == OP_ANDN:
            remap[nid] = g2.ANDN(remap[n.a], remap[n.b])
        elif n.op == OP_MUX:
            remap[nid] = g2.MUX(remap[n.a], remap[n.b], remap[n.c])
        elif n.op == OP_LUT3:
            remap[nid] = _lut3_fold(
                g2, n.aux, [remap[n.a], remap[n.b], remap[n.c]])
        else:  # pragma: no cover
            raise ValueError(n.op)
    for name, bus in graph.inputs.items():
        if name not in g2.inputs:
            g2.input_bus(name, len(bus))
    for name, bus in graph.outputs.items():
        g2.output_bus(name, [remap[w] for w in bus])
    return g2


def const_prop(graph: Graph) -> Graph:
    """Propagate constants / local identities through every gate (also
    sweeps dead nodes; LUT3 cells with degenerate inputs shrink)."""
    return _rebuild(graph)


def sweep(graph: Graph) -> Graph:
    """Drop nodes not reachable from any output (dead-node sweep).

    Structure-preserving: live nodes are copied verbatim (no folding —
    use :func:`const_prop` for that), so mapped cell choices survive."""
    g2 = Graph()
    remap: dict[int, int] = {FALSE: FALSE, TRUE: TRUE}
    for nid in graph.topo_order():
        n = graph.nodes[nid]
        if nid in (FALSE, TRUE):
            continue
        if n.op == OP_INPUT:
            name, _ = n.aux
            if name not in g2.inputs:
                g2.input_bus(name, len(graph.inputs[name]))
            remap[nid] = g2.inputs[name][n.aux[1]]
        elif n.op == OP_CONST:
            remap[nid] = TRUE if n.aux else FALSE
        else:
            remap[nid] = g2._new(
                n.op, remap.get(n.a, -1) if n.a >= 0 else -1,
                remap.get(n.b, -1) if n.b >= 0 else -1,
                remap.get(n.c, -1) if n.c >= 0 else -1, n.aux)
    for name, bus in graph.inputs.items():
        if name not in g2.inputs:
            g2.input_bus(name, len(bus))
    for name, bus in graph.outputs.items():
        g2.output_bus(name, [remap[w] for w in bus])
    return g2


def absorb_andn(graph: Graph) -> Graph:
    """Fuse AND(a, NOT b) -> ANDN(a, b) wherever the NOT has no other
    fanout.  Only valid for libraries with an ANDN cell (avx2/avx512)."""
    fanout: dict[int, int] = {}
    live = graph.topo_order()
    for nid in live:
        n = graph.nodes[nid]
        for ch in (n.a, n.b, n.c):
            if ch >= 0:
                fanout[ch] = fanout.get(ch, 0) + 1
    singles = {nid for nid in live
               if graph.nodes[nid].op == OP_NOT and fanout.get(nid, 0) == 1}
    return _rebuild(graph, andn_fanout1=singles)


def lib_gate_count(graph: Graph, lib_name: str) -> int:
    """Mapped instruction count, with the neon OR(a, NOT b) == ORN fusion
    accounted (the histogram the paper reports)."""
    count = graph.live_gate_count()
    if lib_name == "neon":
        count -= _count_orn(graph)
    return count


def optimize_mapped(graph: Graph, lib_name: str, iters: int = 2) -> Graph:
    """Tech-map + post-mapping clean-up pipeline.

    Runs the priority-cuts mapper, constant propagation / dead-node
    sweep, then up to ``iters - 1`` additional area-flow remap
    iterations (each candidate kept only if it lowers the mapped
    instruction count), and finally ANDN absorption for libraries that
    have the cell.  Semantics-preserving; tests re-verify outputs."""
    lib = CELL_LIBS[lib_name]()
    best = const_prop(tech_map(graph, lib))
    for _ in range(max(0, iters - 1)):
        cand = const_prop(tech_map(best, lib))
        if lib_gate_count(cand, lib_name) < lib_gate_count(best, lib_name):
            best = cand
        else:
            break
    if lib.supports(2, 0b0010) is not None:   # library has an ANDN cell
        cand = absorb_andn(best)
        if lib_gate_count(cand, lib_name) <= lib_gate_count(best, lib_name):
            best = cand
    return best


def gate_report(graph: Graph, libs=None, optimize: bool = True) -> dict:
    """Per-library gate-count report: {lib: {gates, depth, histogram}}.

    ``gates`` is the mapped instruction count after the optimization
    pipeline (or after plain tech mapping when ``optimize=False``)."""
    report = {}
    for lib_name in (libs or CELL_LIBS):
        st = mapped_stats(graph, lib_name, optimize=optimize)
        report[lib_name] = {k: st[k] for k in ("gates", "depth", "histogram")}
    return report


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------
def mapped_stats(graph: Graph, lib_name: str, optimize: bool = False) -> dict:
    """Map `graph` for `lib_name`, return {gates, depth, histogram}."""
    if optimize:
        mapped = optimize_mapped(graph, lib_name)
    else:
        mapped = tech_map(graph, CELL_LIBS[lib_name]())
    hist = mapped.op_histogram()
    if lib_name == "neon":
        # OR(a, NOT b) pairs emitted for ORN count as a single instruction
        norn = _count_orn(mapped)
        if norn:
            hist["ORN"] = norn
            hist["OR"] = hist.get("OR", 0) - norn
            hist["NOT"] = hist.get("NOT", 0) - norn
    gates = sum(hist.values())
    return {"lib": lib_name, "gates": gates, "depth": mapped.depth(),
            "histogram": hist, "graph": mapped}


def _count_orn(g: Graph) -> int:
    """Count OR(x, NOT y) where the NOT has no other fanout."""
    fanout: dict[int, int] = {}
    live = g.topo_order()
    for nid in live:
        n = g.nodes[nid]
        for ch in (n.a, n.b, n.c):
            if ch >= 0:
                fanout[ch] = fanout.get(ch, 0) + 1
    cnt = 0
    for nid in live:
        n = g.nodes[nid]
        if n.op != OP_OR:
            continue
        for ch in (n.a, n.b):
            cn = g.nodes[ch]
            if cn.op == OP_NOT and fanout.get(ch, 0) == 1:
                cnt += 1
                break
    return cnt
