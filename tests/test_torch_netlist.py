"""The port's netlists and netlist executors against the JAX package.

Both packages must build the same netlists (their synthesis modules are
copies), so the generated-source listings are compared as text.  Then
the port's executors — ``make_torch_fn``, the interpreter's instruction
stream run by its plain version, and the fused emitter's torch body —
are held bit-exactly against ``eval_netlist``.
"""
import numpy as np
import pytest
import torch

from repro.core import codegen as jcg
from repro.core import fpcore as jfc
from repro.core import opt as jopt
from repro_torch.core import codegen as tcg
from repro_torch.core import fpcore as tfc
from repro_torch.core import opt as topt
from repro_torch.core.fpformat import HOBFLOPS_FORMATS, RNE, RTZ, FPFormat
from repro_torch.core.fused_backend import (RegisterFileOverflow,
                                            fused_chain_k,
                                            fused_chain_lowered,
                                            lower_netlist)
from repro_torch.core.fused_backend import kernel as fused
from repro_torch.kernels.bitslice_mac import kernel as interp
from repro_torch.kernels.bitslice_mac.program import encode, run_program

F8 = HOBFLOPS_FORMATS["hobflops8"]
F9 = HOBFLOPS_FORMATS["hobflops9"]


def _builders(fmt, rounding):
    """(label, builder name, args) for every netlist the conv path
    runs: the MAC chain at depths 1 and 4, cast, add, max and scale."""
    return [
        ("mac_chain k=1", "build_mac_chain", (fmt, 1, False, rounding)),
        ("mac_chain k=4", "build_mac_chain", (fmt, 4, False, rounding)),
        ("cast", "build_cast", (fmt.mult_out(), fmt, rounding)),
        ("add", "build_add", (fmt, rounding)),
        ("max", "build_max", (fmt,)),
        ("scale", "build_scale", (fmt, 2)),
    ]


@pytest.mark.parametrize("name", ["hobflops8", "hobflops9"])
@pytest.mark.parametrize("rounding", [RNE, RTZ])
def test_emitted_source_equals_reference(name, rounding):
    fmt = HOBFLOPS_FORMATS[name]
    for label, builder, args in _builders(fmt, rounding):
        ours = topt.optimize_mapped(getattr(tfc, builder)(*args), "tpu_vpu")
        ref = jopt.optimize_mapped(getattr(jfc, builder)(*args), "tpu_vpu")
        assert tcg.emit_source(ours) == jcg.emit_source(ref), label
        assert tcg._slot_schedule(ours) == jcg._slot_schedule(ref), label


def test_emitted_source_equals_reference_avx512():
    """The fused backend's netlist (LUT3 cells) is the reference's too."""
    ours = topt.optimize_mapped(tfc.build_mac_chain(F9, 4, False, RNE),
                                "avx512")
    ref = jopt.optimize_mapped(jfc.build_mac_chain(F9, 4, False, RNE),
                               "avx512")
    assert tcg.emit_source(ours) == jcg.emit_source(ref)


def _rand_inputs(graph, rng, lanes=(3, 5)):
    return {bus: rng.integers(-2**31, 2**31, (len(wires),) + lanes,
                              dtype=np.int64).astype(np.int32)
            for bus, wires in graph.inputs.items()}


@pytest.mark.parametrize("name", ["hobflops8", "hobflops9"])
def test_make_torch_fn_matches_eval_netlist(name):
    fmt = HOBFLOPS_FORMATS[name]
    rng = np.random.default_rng(3)
    for label, builder, args in _builders(fmt, RNE):
        if label == "mac_chain k=4":
            continue
        g = topt.optimize_mapped(getattr(tfc, builder)(*args), "tpu_vpu")
        inputs = _rand_inputs(g, rng)
        want = tcg.eval_netlist(g, inputs)
        got = tcg.make_torch_fn(g)(**{k: torch.from_numpy(v)
                                      for k, v in inputs.items()})
        for bus in want:
            np.testing.assert_array_equal(got[bus].numpy(), want[bus],
                                          err_msg=label)


@pytest.mark.parametrize("fmt,k,extended,rounding", [
    (F8, 1, False, RNE), (F9, 4, False, RTZ), (F8, 2, True, RNE)])
def test_interpreter_program_matches_eval_netlist(fmt, k, extended,
                                                  rounding):
    """One chain step of the MAC chain netlist, encoded as an interpreter
    program and run by the interpreter's plain version, equals the
    netlist it encodes."""
    _, g = interp.mac_chain_netlist_fn(fmt, k, extended, rounding)
    buses = ["acc"] + [f"x{j}" for j in range(k)] + [f"y{j}" for j in
                                                      range(k)]
    prog = encode(g, buses)
    assert prog.nout == fmt.mult_out(extended).nbits
    inputs = _rand_inputs(g, np.random.default_rng(k))
    want = tcg.eval_netlist(g, inputs)["out"]
    got = run_program(prog, {bus: list(torch.from_numpy(v))
                             for bus, v in inputs.items()})
    np.testing.assert_array_equal(
        torch.stack([o.expand(3, 5) for o in got]).numpy(), want)


def test_fused_torch_body_matches_eval_netlist():
    lowered = fused_chain_lowered(F9, 2, False, RNE)
    inputs = _rand_inputs(lowered.graph, np.random.default_rng(9))
    want = tcg.eval_netlist(lowered.graph, inputs)["out"]
    got = lowered(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_array_equal(got["out"].numpy(), want)


def test_lut3_anf_all_tables():
    """The algebraic normal form of every 3-input truth table equals its
    minterm expansion on all eight input combinations."""
    a = torch.tensor([0, -1, 0, -1, 0, -1, 0, -1], dtype=torch.int32)
    b = torch.tensor([0, 0, -1, -1, 0, 0, -1, -1], dtype=torch.int32)
    c = torch.tensor([0, 0, 0, 0, -1, -1, -1, -1], dtype=torch.int32)
    for tt in range(256):
        got = tcg.lut3(tt, a, b, c, torch.zeros_like(a))
        want = torch.tensor([-((tt >> m) & 1) for m in range(8)],
                            dtype=torch.int32)
        assert torch.equal(got, want), tt


def test_register_file_overflow_is_raised_at_lowering():
    g = topt.optimize_mapped(tfc.build_mac_chain(F8, 1, False, RNE),
                             "avx512")
    need = lower_netlist(g).nslots
    with pytest.raises(RegisterFileOverflow) as err:
        lower_netlist(g, regfile_size=need - 1)
    assert err.value.need == need and err.value.have == need - 1
    exact = lower_netlist(g, regfile_size=need)
    assert exact.regfile_size == need
    assert f"r{need - 1}" in exact.cuda_body("B") and \
        f"r{need}," not in exact.cuda_body("B")


def test_fused_chain_k_policy():
    """The request capped at the fused depth, never past the request,
    and one step shallower while the chain warps' add-only body outgrows
    the gate budget."""
    assert fused_chain_k(F8, False, 4) == fused.FUSED_DEPTH == 4
    assert fused_chain_k(F9, False, 4) == 4       # 1046 gates at k=4
    assert fused_chain_k(F9, False, 1) == 1
    assert fused_chain_k(F8, False, 2) == 2
    assert fused_chain_k(FPFormat(5, 5), False, 4) == 3   # 961 gates
    assert fused.fused_add_lowered(FPFormat(5, 5), 4, False, RNE) \
        .gate_count() > fused.GATE_BUDGET
    wide = FPFormat(5, 10)        # hobflops16: 878 gates at k=2
    assert fused.fused_add_lowered(wide, 3, False, RNE).gate_count() > \
        fused.GATE_BUDGET
    assert fused_chain_k(wide, False, 4) == 2


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", ["hobflops8", "hobflops9", "hobflops16"])
def test_split_chain_matches_mac_chain(name, k, extended):
    """The multiply-ahead split: products of ``build_mul`` fed through
    the fused kernel's add-only chain (both as the kernel runs them:
    optimized and avx512-mapped) equal ``build_mac_chain`` bit for bit
    on random 32-bit words, exception codes included."""
    fmt = HOBFLOPS_FORMATS[name]
    out_fmt = fmt.mult_out(extended)
    rng = np.random.default_rng(k * 10 + extended)

    def words(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint64) \
            .astype(np.uint32)

    n = 128
    xs, ys = words(k, fmt.nbits, n), words(k, fmt.nbits, n)
    acc = words(out_fmt.nbits, n)
    ins = {"acc": acc}
    for j in range(k):
        ins[f"x{j}"], ins[f"y{j}"] = xs[j], ys[j]
    want = tcg.eval_netlist(tfc.build_mac_chain(fmt, k, extended, RNE),
                            ins)["out"]
    mul = tfc.build_mul(fmt, out_fmt, RNE)
    add = fused.fused_add_lowered(fmt, k, extended, RNE).graph
    pins = {"acc": acc}
    for j in range(k):
        pins[f"p{j}"] = tcg.eval_netlist(mul, {"x": xs[j],
                                               "y": ys[j]})["out"]
        lowered = fused.fused_mul_lowered(fmt, extended, RNE).graph
        assert np.array_equal(
            np.asarray(tcg.eval_netlist(lowered, {"x0": xs[j],
                                                  "y0": ys[j]})["out"]),
            np.asarray(pins[f"p{j}"]))
    got = tcg.eval_netlist(add, pins)["out"]
    assert np.array_equal(np.asarray(got), np.asarray(want))

