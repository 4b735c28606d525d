"""The netlist interpreter's programs (``kernels/bitslice_mac/program.py``)
and its C++ core (``csrc/bitslice_interp.cuh``), on the CPU.

The header is the kernel's own gate evaluator and program loop; here
``g++`` builds it (its inline PTX has a C twin on the host) and runs it
against ``codegen.lut3`` and ``eval_netlist``.  The schedule is checked
by following every row through the groups.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch._build import CSRC
from repro_torch.core.circuit import FALSE, OP_CONST, OP_INPUT, TRUE, Graph
from repro_torch.core.codegen import eval_netlist, lut3
from repro_torch.core.fpcore import build_mac_chain
from repro_torch.core.fpformat import HOBFLOPS_FORMATS, RNE, RTZ, FPFormat
from repro_torch.core.fused_backend.emitter import lop3_imm
from repro_torch.core.fused_backend.kernel import (fused_add_lowered,
                                                   fused_mul_lowered)
from repro_torch.kernels.bitslice_mac import program as pg

F8 = HOBFLOPS_FORMATS["hobflops8"]
F9 = HOBFLOPS_FORMATS["hobflops9"]
F16 = FPFormat(5, 10)

_HARNESS = r"""
#include "bitslice_interp.cuh"
extern "C" void lut_all(const uint32_t* a, const uint32_t* b,
                        const uint32_t* c, uint32_t* out, int n) {
  for (int imm = 0; imm < 256; ++imm) {
    uint4 lo, hi;
    bsi::lut_masks(imm, lo, hi);
    for (int i = 0; i < n; ++i)
      out[imm * n + i] = bsi::lut_mux(lo, hi, a[i], b[i], c[i]);
  }
}
// Run a program over a file of WD lane words (row r of word q at
// r * WD + q), group by group, every slot of every word pair as a warp's
// lanes run them: a group's slots may run in any order.
extern "C" void run(const uint2* prog, int groups, uint32_t* file) {
  constexpr int WD = 4;
  uint4 masks[512];
  for (int i = 0; i < 256; ++i) bsi::mask_row(masks, i);
  bsi::NoProbe pr;
  for (int g = 0; g < groups; ++g)
    for (int q = 0; q < WD; q += 2)
      for (int s = 0; s < bsi::GROUP_MAX; ++s)
        bsi::run_gate<WD>(prog[g * bsi::GROUP_MAX + s], file + q, masks, pr);
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """The header built with the host compiler."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("interp")
    cpp, so = d / "core.cpp", d / "core.so"
    cpp.write_text(_HARNESS)
    subprocess.run([gxx, "-O1", "-std=c++17", "-fno-strict-aliasing",
                    "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so),
                    str(cpp)], check=True)
    return ctypes.CDLL(str(so))


def _words(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


def test_imm_to_tt_inverts_lop3_imm():
    assert [pg.imm_to_tt(lop3_imm(tt)) for tt in range(256)] == \
        list(range(256))


def test_lut3_evaluators_all_truth_tables(core):
    """The kernel's run-time LUT3 (the mux tree), for all 256 truth
    tables, equals ``codegen.lut3`` of the netlist truth table on random
    words."""
    rng = np.random.default_rng(1)
    n = 64
    a, b, c = _words(rng, n), _words(rng, n), _words(rng, n)
    out = np.zeros((256, n), np.uint32)
    core.lut_all(_p(a), _p(b), _p(c), _p(out), n)
    ta, tb, tc = (torch.from_numpy(x.view(np.int32)) for x in (a, b, c))
    zeros = torch.zeros_like(ta)
    for imm in range(256):
        want = lut3(pg.imm_to_tt(imm), ta, tb, tc, zeros).numpy()
        assert (out[imm].view(np.int32) == want).all(), imm


# One chain step of each kind the kernel runs: (format, chain depth of
# the add-only program, or None for the multiplier).
_STEPS = {"hobflops8-add-k2": (F8, 2), "hobflops8-mul": (F8, None),
          "hobflops9-add-k4": (F9, 4), "hobflops9-mul": (F9, None),
          "hobflops16-add-k1": (F16, 1), "hobflops16-mul": (F16, None)}


@pytest.mark.parametrize("fmt,k", _STEPS.values(), ids=_STEPS.keys())
def test_header_runs_encoded_programs(core, fmt, k):
    """The kernel's gate, built from the header, runs an encoded chain
    step slot by slot over a file of two pairs of lane words and leaves
    every output row equal to ``eval_netlist`` of the netlist it
    encodes."""
    if k:
        graph = fused_add_lowered(fmt, k, False, RNE).graph
        prog = pg.add_program(fmt, k, False, RNE)
    else:
        graph = fused_mul_lowered(fmt, False, RNE).graph
        prog = pg.mul_program(fmt, False, RNE)
    rng = np.random.default_rng(2)
    inputs = {bus: _words(rng, len(graph.inputs[bus]), 4)
              for bus, _ in prog.inputs}
    want = eval_netlist(graph, inputs)["out"]
    file = np.zeros((prog.nrows, 4), np.uint32)
    file[pg.ONES_ROW] = 0xFFFFFFFF
    row = pg.FIRST_INPUT_ROW
    for bus, width in prog.inputs:
        file[row:row + width] = inputs[bus]
        row += width
    words = np.ascontiguousarray(prog.words)
    core.run(_p(words), prog.groups, _p(file))
    assert (file[prog.out_rows] == want).all()


def _canon(graph, nid):
    n = graph.nodes[nid]
    if nid in (FALSE, TRUE) or n.op == OP_CONST:
        return TRUE if (nid == TRUE or (nid != FALSE and n.aux)) else FALSE
    return nid


@pytest.mark.parametrize("kind", ["add", "mul", "mac"])
@pytest.mark.parametrize("fmt", [F8, F9], ids=["hobflops8", "hobflops9"])
def test_schedule_groups_and_rows(fmt, kind):
    """Follow every row through the groups: a gate never reads a value
    written inside its own group, no row is both read and written inside
    a group (so its slots run in any order), every row a gate reads
    holds the gate's operand, no gate writes an input row, and the
    output rows hold the outputs at the end."""
    if kind == "add":
        graph = fused_add_lowered(fmt, 2, False, RNE).graph
        buses = ["acc", "p0", "p1"]
    elif kind == "mul":
        graph = fused_mul_lowered(fmt, False, RNE).graph
        buses = ["x0", "y0"]
    else:
        graph = build_mac_chain(fmt, 1, False, RTZ)    # unmapped cells
        buses = ["acc", "x0", "y0"]
    groups, nrows, out_rows = pg.schedule(graph, buses)
    holds = {pg.ZERO_ROW: FALSE, pg.ONES_ROW: TRUE}
    row = pg.FIRST_INPUT_ROW
    for bus in buses:
        for nid in graph.inputs[bus]:
            holds[row] = nid
            row += 1
    n_inputs = row
    done = set()
    for grp in groups:
        assert 1 <= len(grp) <= pg.GROUP_MAX
        made = {g.node for g in grp}
        for g in grp:
            n = graph.nodes[g.node]
            if n.op == OP_INPUT:                  # an output's copy
                kids = [g.node]
            else:
                kids = [c for c in (n.a, n.b, n.c) if c >= 0]
            assert not made & {c for c in kids if c != g.node}
            want = [_canon(graph, c) for c in kids]
            want += [FALSE] * (3 - len(want))
            assert [holds.get(r) for r in g.src] == want, g
            assert g.dst >= n_inputs and g.dst < nrows
        assert not {g.dst for g in grp} & {r for g in grp for r in g.src}
        assert len({g.dst for g in grp}) == len(grp)
        for g in grp:
            holds[g.dst] = g.node
        done |= made
    outs = [_canon(graph, w) for bus in graph.outputs.values() for w in bus]
    assert [holds[r] for r in out_rows] == outs
    assert len(done) == sum(len(g) for g in groups)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("fmt", [F8, F9, F16],
                         ids=["hobflops8", "hobflops9", "hobflops16"])
def test_mul_and_add_programs_equal_mac_chain(fmt, k):
    """The multiplier program on each channel, then the k-step add-only
    program, both run by the plain interpreter, equal ``build_mac_chain``
    bit for bit on random words."""
    rng = np.random.default_rng(k)
    n = 16
    xs, ys = _words(rng, k, fmt.nbits, n), _words(rng, k, fmt.nbits, n)
    acc = _words(rng, fmt.mult_out().nbits, n)
    ins = {"acc": acc}
    for j in range(k):
        ins[f"x{j}"], ins[f"y{j}"] = xs[j], ys[j]
    want = eval_netlist(build_mac_chain(fmt, k, False, RNE), ins)["out"]

    def t(a):
        return list(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)))

    mul = pg.mul_program(fmt, False, RNE)
    add = pg.add_program(fmt, k, False, RNE)
    pins = {"acc": t(acc)}
    for j in range(k):
        pins[f"p{j}"] = [o.expand(n) for o in
                         pg.run_program(mul, {"x0": t(xs[j]),
                                              "y0": t(ys[j])})]
    got = torch.stack([o.expand(n) for o in pg.run_program(add, pins)])
    assert (got.numpy().view(np.uint32) == want).all()


def test_program_rows_past_the_encoding_raise():
    """A netlist needing more rows than a gate can address raises
    instead of being truncated; one that fits encodes every gate."""
    for width, ok in ((pg.MAX_ROWS - 3, True), (pg.MAX_ROWS, False)):
        g = Graph()
        bus = g.input_bus("x0", width)
        g.output_bus("out", [g.XOR(bus[0], bus[-1])])
        if ok:
            prog = pg.encode(g, ["x0"])
            assert prog.n == 1 and prog.nrows == pg.MAX_ROWS
        else:
            with pytest.raises(ValueError, match="rows"):
                pg.encode(g, ["x0"])
