"""The netlist interpreter's programs: schedule, encoding and plain run.

A mapped netlist becomes a :class:`Program` that the CUDA interpreter
(``csrc/bitslice_mac.cu``, loop in ``csrc/bitslice_interp.cuh``) and
:func:`run_program` both execute.  One encoding serves every netlist,
cell library, format and chain depth; nothing is emitted or compiled per
netlist.

**Rows.**  A program runs over a file of rows, one 32-bit lane word each:
row 0 holds 0, row 1 all ones, rows 2.. the input buses in the order the
program names them, then temporaries.  Output bits name rows too (a
constant output names row 0 or 1).

**Gates.**  Every gate is a LUT3 over three rows, written to a fourth:
two-input cells read row 0 as their third operand, and each cell's
function becomes a PTX ``lop3.b32`` truth table (``imm``: bit
``4a + 2b + c``).  A gate is 8 bytes::

    x = a | b << 12 | imm << 24
    y = c | d << 12 | 1 << 24      (an empty slot is all zero)

so a program addresses up to 4096 rows — far more than a block's shared
memory holds, which the launch checks first.

**Schedule.**  Gates are ordered by level (ASAP depth) and packed into
groups of at most :data:`GROUP_MAX` that read nothing written inside
their own group; each group fills :data:`GROUP_MAX` slots, the unused
ones empty.  The kernel gives each pair of lane words up to
:data:`GROUP_MAX` lanes, each running its slots of a group, so a group's
gates run side by side and a warp waits once a group.  Rows are
allocated group by group: a row read for the last time in a group is
free from the next group on, so no row is both read and written inside
a group and its slots may run in any order; an output row is never
reused, and no result is written to an input row — an output that is an
input bit gets a copy gate — so copying the outputs into the
accumulator rows after a step cannot overwrite an output.  This
scheduler is the interpreter's own; ``core.codegen._slot_schedule``
(one gate at a time) is left as the reference has it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.circuit import (FALSE, OP_AND, OP_ANDN, OP_CONST,
                                      OP_INPUT, OP_LUT3, OP_MUX, OP_NOT,
                                      OP_OR, OP_XOR, TRUE, Graph)
from repro_torch.core.codegen import lut3
from repro_torch.core.fpformat import FPFormat
from repro_torch.core.fused_backend.emitter import lop3_imm
from repro_torch.core.fused_backend.kernel import (fused_add_lowered,
                                                   fused_mul_lowered)
from repro_torch.core.fused_backend.netlists import (build_add_chain,
                                                     build_mul_step)
from repro_torch.core.opt import optimize_mapped

# Shared with csrc/bitslice_interp.cuh.
ROW_BITS = 12
MAX_ROWS = 1 << ROW_BITS
GROUP_MAX = 8                  # slots a group: lanes a word pair at most
ZERO_ROW, ONES_ROW, FIRST_INPUT_ROW = 0, 1, 2

# The cell library the interpreter runs by default: avx512's LUT3 cells
# take half the gates of tpu_vpu's two-input cells, and every gate costs
# the interpreter one run-time LUT3 either way
# (scripts/torch_interp_probe.py).
LIB = "avx512"

# lop3 truth tables over (a, b, c) = (0xF0, 0xCC, 0xAA).
_IMM = {OP_NOT: 0x0F, OP_AND: 0xC0, OP_OR: 0xFC, OP_XOR: 0x3C,
        OP_ANDN: 0x30, OP_MUX: 0xCA}
IMM_COPY = 0xF0


def imm_to_tt(imm: int) -> int:
    """The netlist truth table (bit ``a + 2b + 4c``) of a lop3 ``imm``
    (bit ``4a + 2b + c``); the inverse of ``emitter.lop3_imm``."""
    return sum(1 << (((i >> 2) & 1) | (i & 2) | ((i & 1) << 2))
               for i in range(8) if (imm >> i) & 1)


@dataclasses.dataclass(frozen=True)
class Gate:
    """One scheduled gate: ``node`` computed as ``lop3(imm)`` of the rows
    ``src`` into row ``dst``."""
    node: int
    imm: int
    src: tuple[int, int, int]
    dst: int


@dataclasses.dataclass(frozen=True, eq=False)
class Program:
    """A netlist encoded for the interpreter (see the module docstring).

    ``words`` is ``[groups + 1, GROUP_MAX, 2]`` int32: the two words of
    each slot as uint32 bit patterns, group by group, then an empty
    group the kernel reads ahead into; ``n`` counts the gates.
    ``inputs`` names each input bus and its width in row order from row
    2; ``out_rows`` holds the row of each output bit.
    """
    words: np.ndarray
    n: int
    groups: int
    nrows: int
    inputs: tuple[tuple[str, int], ...]
    out_rows: np.ndarray

    @property
    def nout(self) -> int:
        return len(self.out_rows)

    @functools.cached_property
    def decoded(self) -> list[list[tuple[int, int, int, int, int]]]:
        """The groups of ``(imm, a, b, c, d)`` read back from ``words``,
        as the kernel reads them (empty slots left out)."""
        w = self.words.view(np.uint32).astype(np.int64)[:self.groups]
        mask = MAX_ROWS - 1
        return [[(int(x >> 24), int(x & mask), int((x >> ROW_BITS) & mask),
                  int(y & mask), int((y >> ROW_BITS) & mask))
                 for x, y in grp if y >> 24]
                for grp in w]


def _const_of(graph: Graph, nid: int) -> int | None:
    n = graph.nodes[nid]
    if nid in (FALSE, TRUE) or n.op == OP_CONST:
        return TRUE if (nid == TRUE or (nid != FALSE and n.aux)) else FALSE
    return None


def schedule(graph: Graph, input_buses) -> tuple[list[list[Gate]], int,
                                                  list[int]]:
    """Levelized, grouped, row-allocated schedule of ``graph`` whose
    inputs occupy rows in the order of ``input_buses``.  Returns
    ``(groups, nrows, out_rows)``."""
    nodes = graph.nodes
    row_of: dict[int, int] = {FALSE: ZERO_ROW, TRUE: ONES_ROW}
    row = FIRST_INPUT_ROW
    for bus in input_buses:
        for nid in graph.inputs[bus]:
            row_of[nid] = row
            row += 1
    first_temp = row

    def src_row(ch):
        c = _const_of(graph, ch)
        return row_of[ch if c is None else c]

    order = graph.topo_order()
    gates = [n for n in order if _const_of(graph, n) is None
             and nodes[n].op != OP_INPUT]
    outs = [w for bus in graph.outputs.values() for w in bus]
    # An output that is an input bit is copied into a temporary row.
    copies = [w for w in dict.fromkeys(outs) if nodes[w].op == OP_INPUT]

    level = {}
    for nid in gates:
        n = nodes[nid]
        level[nid] = 1 + max((level.get(ch, 0) for ch in (n.a, n.b, n.c)
                              if ch >= 0), default=0)
    for nid in copies:
        level[nid] = 1
    pos = {nid: i for i, nid in enumerate(gates)}
    seq = sorted(copies) + sorted(gates, key=lambda g: (level[g], pos[g]))

    def kids(nid):
        if nid in copies:
            return [nid]
        n = nodes[nid]
        return [ch for ch in (n.a, n.b, n.c) if ch >= 0]

    packed, cur = [], []
    for nid in seq:
        if len(cur) == GROUP_MAX or any(ch in cur for ch in kids(nid)):
            packed.append(cur)
            cur = []
        cur.append(nid)
    if cur:
        packed.append(cur)

    # The last group reading each value (inputs and constants keep their
    # rows; outputs keep theirs to the end).
    last = {}
    for gi, grp in enumerate(packed):
        for nid in grp:
            for ch in kids(nid):
                last[ch] = gi
    pinned = set(outs)
    free: list[int] = []
    nrows = first_temp
    groups = []
    result_row: dict[int, int] = {}
    for gi, grp in enumerate(packed):
        srcs = {}
        for nid in grp:
            if nid in copies:
                srcs[nid] = (row_of[nid], ZERO_ROW, ZERO_ROW)
                continue
            n = nodes[nid]
            rows = [src_row(ch) for ch in (n.a, n.b, n.c) if ch >= 0]
            srcs[nid] = tuple(rows + [ZERO_ROW] * (3 - len(rows)))
        out = []
        for nid in grp:
            if free:
                dst = free.pop()
            else:
                dst = nrows
                nrows += 1
            result_row[nid] = dst
            if nid in copies:
                imm = IMM_COPY
            elif nodes[nid].op == OP_LUT3:
                imm = lop3_imm(nodes[nid].aux)
            else:
                imm = _IMM[nodes[nid].op]
            out.append(Gate(nid, imm, srcs[nid], dst))
        # Rows read for the last time here, and results read by no gate,
        # are free from the next group on.
        for ch in {ch for nid in grp for ch in kids(nid)}:
            if last.get(ch) == gi and ch in result_row and ch not in pinned:
                free.append(result_row[ch])
        for nid in grp:
            if nid not in last and nid not in pinned:
                free.append(result_row[nid])
        groups.append(out)
        for nid in grp:
            if nid not in copies:
                row_of[nid] = result_row[nid]
    out_rows = []
    for w in outs:
        c = _const_of(graph, w)
        out_rows.append(row_of[c] if c is not None else result_row[w])
    return groups, nrows, out_rows


def encode(graph: Graph, input_buses) -> Program:
    """Schedule and encode ``graph`` (inputs in rows in the order of
    ``input_buses``).  Raises if it needs more rows than a gate can
    address; a program is never truncated."""
    groups, nrows, out_rows = schedule(graph, list(input_buses))
    if nrows > MAX_ROWS:
        raise ValueError(f"netlist needs {nrows} rows; the interpreter's "
                         f"encoding addresses {MAX_ROWS}")
    words = np.zeros((len(groups) + 1, GROUP_MAX, 2), np.uint32)
    for gi, grp in enumerate(groups):
        for i, g in enumerate(grp):
            a, b, c = g.src
            words[gi, i] = (a | b << ROW_BITS | g.imm << 24,
                            c | g.dst << ROW_BITS | 1 << 24)
    return Program(words.view(np.int32), sum(len(g) for g in groups),
                   len(groups), nrows,
                   tuple((b, len(graph.inputs[b])) for b in input_buses),
                   np.asarray(out_rows, np.int32))


@functools.lru_cache(maxsize=None)
def add_program(fmt: FPFormat, k: int, extended: bool, rounding: str,
                lib: str = LIB) -> Program:
    """The k-step add-only chain (``netlists.build_add_chain``) the chain
    warps interpret: inputs ``acc`` then ``p0 .. p{k-1}``.  Its avx512
    netlist is the fused kernel's own."""
    graph = (fused_add_lowered(fmt, k, extended, rounding).graph
             if lib == "avx512" else
             optimize_mapped(build_add_chain(fmt, k, extended, rounding),
                             lib))
    return encode(graph, ["acc"] + [f"p{j}" for j in range(k)])


@functools.lru_cache(maxsize=None)
def mul_program(fmt: FPFormat, extended: bool, rounding: str,
                lib: str = LIB) -> Program:
    """The multiplier (``netlists.build_mul_step``) the producer warps
    interpret ahead of the chain: inputs ``x0`` then ``y0``."""
    graph = (fused_mul_lowered(fmt, extended, rounding).graph
             if lib == "avx512" else
             optimize_mapped(build_mul_step(fmt, extended, rounding), lib))
    return encode(graph, ["x0", "y0"])


_TT = [imm_to_tt(i) for i in range(256)]


def run_program(prog: Program, inputs: dict) -> list:
    """Plain torch run of ``prog``: ``inputs`` maps each input bus to its
    list of lane-word tensors (mutually broadcastable); returns the
    output tensors.  It decodes the same words the kernel reads and
    keeps its group order (a group's loads before its stores), so the
    CPU tests check the encoding itself."""
    sample = next(iter(inputs.values()))[0]
    zeros = torch.zeros((), dtype=sample.dtype, device=sample.device)
    rows: list = [zeros, ~zeros]
    for bus, width in prog.inputs:
        if len(inputs[bus]) != width:
            raise ValueError(f"bus {bus}: {len(inputs[bus])} words for "
                             f"width {width}")
        rows += list(inputs[bus])
    rows += [None] * (prog.nrows - len(rows))
    for grp in prog.decoded:
        vals = [lut3(_TT[imm], rows[a], rows[b], rows[c], zeros)
                for imm, a, b, c, _ in grp]
        for (*_, d), v in zip(grp, vals):
            rows[d] = v
    return [rows[r] for r in prog.out_rows.tolist()]
