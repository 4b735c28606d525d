"""The bitslice-parallel HOBFLOPS MAC (GEMM form) as a CUDA netlist
interpreter, with its plain torch version.

Port of ``repro.kernels.bitslice_mac.kernel.bitslice_mac_pallas``:

* Weights are bitsliced along the M (output-channel) axis — the paper's
  "tile the M kernels by LANES"; IFM bits are broadcast to all lanes as
  0/-1 masks — the paper's "broadcast the IFM channel across kernels".
* Channels advance ``c_unroll`` at a time through a fused K-step MAC
  chain netlist (``build_mac_chain``) mapped to the ``tpu_vpu`` cell
  library (NOT/AND/OR/XOR/ANDN/MUX).
* The netlist runs as an int32 instruction stream (:func:`mac_program`)
  that ``csrc/bitslice_mac.cu`` interprets; one build serves every
  format, chain depth and rounding.  Each thread owns one (row, lane
  word) and folds all C channels in order; see the source's header
  note for what bounds it on the H100.

Layouts:
    i_masks : [P, C, NIN]  int32, each element 0 or -1 (bit broadcast)
    w_planes: [C, NIN, Mw] int32, bit b of weight (c, 32*w+j) in bit j
              of w_planes[c, b, w]
    out     : [NOUT, P, Mw] int32 OFM bit planes
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _build
from repro_torch.core.circuit import (OP_AND, OP_ANDN, OP_INPUT, OP_LUT3,
                                      OP_MUX, OP_NOT, OP_OR, OP_XOR)
from repro_torch.core.codegen import _slot_schedule, lut3, make_torch_fn
from repro_torch.core.fpcore import (build_add, build_cast, build_mac_chain,
                                     build_max, build_scale)
from repro_torch.core.fpformat import RNE, FPFormat
from repro_torch.core.opt import optimize_mapped


def _optimized_fn(graph, lib: str):
    """Map a freshly built netlist into ``lib`` cells, run the
    post-mapping optimization passes (constant propagation, remap
    iteration, dead-node sweep), and wrap it as a torch function.
    Every ``*_netlist_fn`` below caches through this, so each
    (builder, format, options) combination pays graph construction,
    mapping and register allocation once per process."""
    mapped = optimize_mapped(graph, lib)
    return make_torch_fn(mapped), mapped


@functools.lru_cache(maxsize=None)
def mac_chain_netlist_fn(fmt: FPFormat, k: int, extended: bool,
                         rounding: str, lib: str = "tpu_vpu"):
    """Optimized ``lib``-mapped K-step MAC chain, bit-exact to ``k``
    sequential MAC steps."""
    return _optimized_fn(build_mac_chain(fmt, k, extended, rounding), lib)


@functools.lru_cache(maxsize=None)
def cast_netlist_fn(fmt_in: FPFormat, fmt_out: FPFormat, rounding: str,
                    lib: str = "tpu_vpu"):
    """Optimized fmt_in -> fmt_out cast: the inter-layer boundary op of
    the bitslice-resident pipeline, a few dozen bitwise ops over the
    plane array in place of unpack -> decode -> encode -> repack."""
    return _optimized_fn(build_cast(fmt_in, fmt_out, rounding), lib)


@functools.lru_cache(maxsize=None)
def add_netlist_fn(fmt: FPFormat, rounding: str = RNE,
                   lib: str = "tpu_vpu"):
    """Optimized elementwise FP adder — the residual-merge and
    avgpool-tree op of the graph runner."""
    return _optimized_fn(build_add(fmt, rounding), lib)


@functools.lru_cache(maxsize=None)
def max_netlist_fn(fmt: FPFormat, lib: str = "tpu_vpu"):
    """Optimized elementwise FP max — the plane-domain maxpool
    reduction."""
    return _optimized_fn(build_max(fmt), lib)


@functools.lru_cache(maxsize=None)
def scale_netlist_fn(fmt: FPFormat, k: int, lib: str = "tpu_vpu"):
    """Optimized multiply-by-2**-k — the divider-free avgpool tail."""
    return _optimized_fn(build_scale(fmt, k), lib)


# ---------------------------------------------------------------------------
# The instruction stream of the interpreter
# ---------------------------------------------------------------------------
CONST0, CONST1 = -1, -2        # source operands that read 0 / all-ones


@dataclasses.dataclass(frozen=True, eq=False)
class MacProgram:
    """A k-step MAC chain netlist encoded for ``csrc/bitslice_mac.cu``.

    ``instr`` is ``[n, 4]`` int32, one row per gate in schedule order:
    ``op | truth_table << 4 | dst_slot << 12`` (op codes are
    ``circuit.OP_*``), then three source slots (``CONST0``/``CONST1``
    for the constants, unused trailing sources ``CONST0``).  An INPUT
    row's first source is a bus-bit index: ``[0, k*nin)`` weight planes
    ``x{j}``, ``[k*nin, 2k*nin)`` IFM masks ``y{j}``, then the
    accumulator bits.  ``out_desc`` names the slot (or constant) of
    each output bit.
    """
    instr: np.ndarray
    out_desc: np.ndarray
    nslots: int
    nin: int
    nout: int
    k: int


def encode_program(graph, k: int, nin: int) -> MacProgram:
    """Encode a mapped MAC-chain netlist as an interpreter program."""
    steps, nslots, out_wires = _slot_schedule(graph)
    nodes = graph.nodes
    rows = []
    for nid, slot, cs, _ in steps:
        n = nodes[nid]
        if n.op == OP_INPUT:
            name, bit = n.aux
            if name == "acc":
                idx = 2 * k * nin + bit
            else:
                j = int(name[1:])
                idx = (j if name[0] == "x" else k + j) * nin + bit
            rows.append((OP_INPUT | slot << 12, idx, CONST0, CONST0))
            continue
        children = [ch for ch in (n.a, n.b, n.c) if ch >= 0]
        srcs = [s if s >= 0 else (CONST1 if nodes[ch].aux else CONST0)
                for s, ch in zip(cs, children)]
        srcs += [CONST0] * (3 - len(srcs))
        tt = n.aux if n.op == OP_LUT3 else 0
        rows.append((n.op | tt << 4 | slot << 12, *srcs))
    out_desc = [s if kind == "slot" else (CONST1 if s else CONST0)
                for kind, s in out_wires["out"]]
    return MacProgram(np.asarray(rows, np.int32).reshape(-1, 4),
                      np.asarray(out_desc, np.int32), nslots, nin,
                      len(out_desc), k)


@functools.lru_cache(maxsize=None)
def mac_program(fmt: FPFormat, k: int, extended: bool, rounding: str,
                lib: str = "tpu_vpu") -> MacProgram:
    """The interpreter program of the cached chain netlist."""
    _, mapped = mac_chain_netlist_fn(fmt, k, extended, rounding, lib)
    return encode_program(mapped, k, fmt.nbits)


def run_program(prog: MacProgram, xs, ys, acc):
    """Plain torch execution of one chain step of ``prog``: ``xs``/``ys``
    are k lists of NIN lane-word tensors, ``acc`` NOUT of them; returns
    the NOUT output tensors.  The same decode as the CUDA interpreter,
    so the CPU tests check the encoding itself."""
    inputs = [t for bus in xs for t in bus] + \
        [t for bus in ys for t in bus] + list(acc)
    zeros = torch.zeros_like(acc[0])
    ones = ~zeros
    regs: list = [None] * prog.nslots

    def rd(s):
        return regs[s] if s >= 0 else (ones if s == CONST1 else zeros)

    for head, a, b, c in prog.instr.tolist():
        op, tt, dst = head & 15, (head >> 4) & 255, head >> 12
        if op == OP_INPUT:
            v = inputs[a]
        elif op == OP_NOT:
            v = ~rd(a)
        elif op == OP_MUX:
            s, x, y = rd(a), rd(b), rd(c)
            v = y ^ (s & (x ^ y))
        elif op == OP_AND:
            v = rd(a) & rd(b)
        elif op == OP_OR:
            v = rd(a) | rd(b)
        elif op == OP_XOR:
            v = rd(a) ^ rd(b)
        elif op == OP_ANDN:
            v = rd(a) & ~rd(b)
        elif op == OP_LUT3:
            v = lut3(tt, rd(a), rd(b), rd(c), zeros)
        else:  # pragma: no cover
            raise ValueError(f"bad op {op}")
        regs[dst] = v
    return [rd(s) for s in prog.out_desc.tolist()]


def _bitslice_mac_torch(i_masks, w_planes, *, fmt: FPFormat, extended: bool,
                        rounding: str, c_unroll: int | None = None):
    """Plain version: the chain program stepped over C/c_unroll channel
    groups with one torch op per gate.  C is padded to a multiple of
    ``c_unroll`` with +0 codes — the all-zero planes — which are the
    MAC identity."""
    P, C, nin = i_masks.shape
    Mw = w_planes.shape[2]
    k = _build.chain_depth(C, c_unroll)
    pad = (-C) % k
    if pad:
        i_masks = F.pad(i_masks, (0, 0, 0, pad))
        w_planes = F.pad(w_planes, (0, 0, 0, 0, 0, pad))
        C += pad
    prog = mac_program(fmt, k, extended, rounding)
    acc = [torch.zeros((P, Mw), dtype=torch.int32, device=i_masks.device)
           for _ in range(prog.nout)]
    for s in range(0, C, k):
        xs = [[w_planes[s + j, b][None, :] for b in range(nin)]
              for j in range(k)]                                  # [1, Mw]
        ys = [[i_masks[:, s + j, b][:, None] for b in range(nin)]
              for j in range(k)]                                  # [P, 1]
        acc = [o.expand(P, Mw) for o in run_program(prog, xs, ys, acc)]
    return torch.stack(acc).contiguous()


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------
def build_job() -> tuple[str, str]:
    """The ``(name, source)`` pair :func:`_build.build` compiles."""
    return "bitslice_mac", (_build.CSRC / "bitslice_mac.cu").read_text()


# The bound C entry, once a library is loaded (built at first launch, or
# ahead of time through ``repro_torch.kernels.build_kernels``).
_BOUND: dict = {}


def load(library: _build.Library) -> None:
    """Bind the C entry of a built ``bitslice_mac`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _BOUND["launch"] = _build.bind(
        library.lib, "bitslice_mac_launch",
        [vp, vp, vp, vp, ci, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp])


def _launch_fn():
    if "launch" not in _BOUND:
        load(_build.build([build_job()])[0])
    return _BOUND["launch"]


@functools.lru_cache(maxsize=None)
def _device_program(fmt, k, extended, rounding, device: str):
    prog = mac_program(fmt, k, extended, rounding)
    return (prog, torch.from_numpy(prog.instr).to(device).contiguous(),
            torch.from_numpy(prog.out_desc).to(device).contiguous())


def smem_bytes(nslots: int, nin: int, nout: int, p_block: int,
               m_block: int, c_block: int) -> int:
    """Dynamic shared memory of one interpreter block (mirrors
    ``bitslice_mac_smem_bytes`` in the source)."""
    return 4 * ((m_block + p_block) * (c_block * nin + 1)
                + (nslots + nout) * m_block * p_block)


def bitslice_mac_cuda(i_masks: torch.Tensor, w_planes: torch.Tensor, *,
                      fmt: FPFormat, extended: bool = False,
                      rounding: str = RNE, c_unroll: int | None = None,
                      p_block: int | None = None,
                      m_block: int | None = None,
                      c_block: int | None = None):
    """HOBFLOPS GEMM in bit planes: i_masks [P, C, NIN] in {0, -1},
    w_planes [C, NIN, Mw] -> [NOUT, P, Mw] int32.

    On CUDA tensors this launches ``csrc/bitslice_mac.cu`` (blocks of
    ``m_block x p_block`` threads, C tiles of ``c_block`` channels
    rounded up to a multiple of the chain depth; missing values from
    :func:`_build.launch_blocks`); on CPU tensors it runs the plain
    version.  Any shape is accepted — the kernel masks the ragged P, Mw
    and C edges — and the output never depends on the blocks.
    """
    P, C, nin = i_masks.shape
    C2, nin2, Mw = w_planes.shape
    if (C, nin) != (C2, nin2) or nin != fmt.nbits:
        raise ValueError(f"bad operand shapes {tuple(i_masks.shape)} x "
                         f"{tuple(w_planes.shape)} for {fmt}")
    if i_masks.device.type == "cpu" and w_planes.device.type == "cpu":
        return _bitslice_mac_torch(i_masks, w_planes, fmt=fmt,
                                   extended=extended, rounding=rounding,
                                   c_unroll=c_unroll)
    _build.require_cuda(i_masks, w_planes)
    blk = _build.launch_blocks(P, C, Mw, p_block=p_block, m_block=m_block,
                               c_block=c_block, c_unroll=c_unroll)
    k, p_block, m_block = blk["c_unroll"], blk["p_block"], blk["m_block"]
    prog, instr, out_desc = _device_program(fmt, k, extended, rounding,
                                            str(i_masks.device))
    ct = _build.c_tile(blk["c_block"], k)
    smem = smem_bytes(prog.nslots, nin, prog.nout, p_block, m_block, ct)
    _build.check_blocks(p_block, m_block, ct, smem)
    fn = _launch_fn()
    out = torch.empty((prog.nout, P, Mw), dtype=torch.int32,
                      device=i_masks.device)
    with torch.cuda.device(i_masks.device):
        code = fn(_build.ptr(i_masks), _build.ptr(w_planes), _build.ptr(out),
                  _build.ptr(instr), len(prog.instr), _build.ptr(out_desc),
                  prog.nslots, nin, prog.nout, k, P, C, Mw, p_block,
                  m_block, ct, _build.stream_ptr())
    _build.check(code, "bitslice_mac")
    bitslice_mac_cuda.launches += 1
    return out


bitslice_mac_cuda.launches = 0
