"""The bitslice-parallel HOBFLOPS MAC (GEMM form) as a CUDA netlist
interpreter, with its plain torch version.

Port of ``repro.kernels.bitslice_mac.kernel.bitslice_mac_pallas``:

* Weights are bitsliced along the M (output-channel) axis — the paper's
  "tile the M kernels by LANES"; IFM bits are broadcast to all lanes as
  0/-1 masks — the paper's "broadcast the IFM channel across kernels".
* Channels advance ``c_unroll`` at a time through a k-step MAC chain,
  split as the fused kernel splits it: the multiplier
  (:func:`.program.mul_program`) runs ahead of the k-step add-only chain
  (:func:`.program.add_program`), bit-exact to ``build_mac_chain``.
* Both netlists run as encoded programs (:mod:`.program`) that
  ``csrc/bitslice_mac.cu`` interprets: one build serves every format,
  chain depth, rounding and cell library (``avx512`` by default).  Each
  chain thread owns one (row, lane word) and folds all C channels in
  order; producer warps stage the channels and multiply; see the
  source's header note for what bounds it on the H100.

Layouts:
    i_masks : [P, C, NIN]  int32, each element 0 or -1 (bit broadcast)
    w_planes: [C, NIN, Mw] int32, bit b of weight (c, 32*w+j) in bit j
              of w_planes[c, b, w]
    out     : [NOUT, P, Mw] int32 OFM bit planes
"""
from __future__ import annotations

import ctypes
import functools
import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _build
from repro_torch.core.codegen import make_torch_fn
from repro_torch.core.fpcore import (build_add, build_cast, build_mac_chain,
                                     build_max, build_scale)
from repro_torch.core.fpformat import RNE, FPFormat
from repro_torch.core.opt import optimize_mapped

from .program import LIB, Program, add_program, mul_program, run_program


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
# The plain version
# ---------------------------------------------------------------------------
def _bitslice_mac_torch(i_masks, w_planes, *, fmt: FPFormat, extended: bool,
                        rounding: str, c_unroll: int | None = None):
    """Plain version: the kernel's two programs run by :func:`run_program`
    over C/c_unroll channel groups in order — the multiplier on the
    group's channels, then the add-only chain.  C is padded to a multiple
    of ``c_unroll`` with +0 codes — the all-zero planes — which are the
    MAC identity."""
    P, C, nin = i_masks.shape
    Mw = w_planes.shape[2]
    k = _build.chain_depth(C, c_unroll)
    pad = (-C) % k
    if pad:
        i_masks = F.pad(i_masks, (0, 0, 0, pad))
        w_planes = F.pad(w_planes, (0, 0, 0, 0, 0, pad))
        C += pad
    mul = mul_program(fmt, extended, rounding)
    add = add_program(fmt, k, extended, rounding)
    acc = [torch.zeros((P, Mw), dtype=torch.int32, device=i_masks.device)
           for _ in range(add.nout)]
    for s in range(0, C, k):
        prods = run_program(mul, {
            "x0": [w_planes[s:s + k, b, None, :] for b in range(nin)],
            "y0": [i_masks[:, s:s + k, b].T[:, :, None]
                   for b in range(nin)]})                   # [k, P, Mw]
        prods = [p.expand(k, P, Mw) for p in prods]
        ins = {"acc": acc}
        for j in range(k):
            ins[f"p{j}"] = [p[j] for p in prods]
        acc = [o.expand(P, Mw) for o in run_program(add, ins)]
    return torch.stack(acc).contiguous()


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------
def build_job(defines: str = "") -> tuple[str, str]:
    """The ``(name, source)`` pair :func:`_build.build` compiles;
    ``defines`` (``#define`` lines put first) builds a variant under its
    own name (``scripts/torch_interp_probe.py``)."""
    src = (_build.CSRC / "bitslice_mac.cu").read_text()
    if not defines:
        return "bitslice_mac", src
    tag = hashlib.sha256(defines.encode()).hexdigest()[:8]
    return f"bitslice_mac_{tag}", defines + "\n" + src


# The bound C entry, once a library is loaded (built at first launch, or
# ahead of time through ``repro_torch.kernels.build_kernels``).
_BOUND: dict = {}

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int32)]
         + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def bind(library: _build.Library, probe: bool = False):
    """The launch entry of a built library: ``bitslice_mac_launch`` or,
    with ``probe``, the measurement-only ``bitslice_mac_probe`` (one more
    pointer: 8 counters a warp)."""
    if probe:
        return _build.bind(library.lib, "bitslice_mac_probe",
                           _ARGS + [ctypes.c_void_p])
    return _build.bind(library.lib, "bitslice_mac_launch", _ARGS)


def load(library: _build.Library) -> None:
    """Bind the C entry of a built ``bitslice_mac`` library."""
    _BOUND["launch"] = bind(library)


def _launch_fn():
    if "launch" not in _BOUND:
        load(_build.build([build_job()])[0])
    return _BOUND["launch"]


class DevicePrograms:
    """The multiplier and the add-only chain of one (format, chain
    depth, extended, rounding, library) on one device: ``blob`` holds
    both programs' words and output rows (each part padded to 16 bytes,
    the kernel stages it with 16-byte copies), ``meta`` their counts and
    offsets in words, as the C entry reads them."""

    def __init__(self, mul: Program, add: Program, device):
        parts, offs = [], []
        for arr in (add.words.ravel(), mul.words.ravel(), add.out_rows,
                    mul.out_rows):
            offs.append(sum(len(p) for p in parts))
            parts.append(np.pad(arr, (0, (-len(arr)) % 4)))
        blob = np.concatenate(parts).astype(np.int32)
        self.mul, self.add = mul, add
        self.blob = torch.from_numpy(blob).to(device)
        self.program_bytes = 4 * len(blob)
        self.meta = (ctypes.c_int32 * 8)(
            len(blob), add.groups, add.nrows, offs[1], mul.groups,
            mul.nrows, offs[2], offs[3])


@functools.lru_cache(maxsize=None)
def device_programs(fmt: FPFormat, k: int, extended: bool, rounding: str,
                    lib: str, device: str) -> DevicePrograms:
    return DevicePrograms(mul_program(fmt, extended, rounding, lib),
                          add_program(fmt, k, extended, rounding, lib),
                          device)


STAGES = 3          # ring slots of products (hf::STAGES)


LANES_A_PAIR = (8, 4, 2, 1)     # lanes a pair of chains the kernel runs


def padded_chains(p_block: int, m_block: int, gs: int) -> int:
    """A block's ``p_block x m_block`` chains (lane words) padded to
    whole warps of ``64 // gs`` chains: ``gs`` lanes a pair of them."""
    wd = 64 // gs
    return -(-p_block * m_block // wd) * wd


def block_threads(p_block: int, m_block: int, pw: int, gs: int) -> int:
    """Threads of one interpreter block: the chain warps and ``pw``
    producer warps for each."""
    return (1 + pw) * padded_chains(p_block, m_block, gs) * gs // 2


def lanes_a_pair(p_block: int, m_block: int, pw: int) -> int:
    """Lanes a pair of chains: :data:`GROUP_MAX` (one a slot of a group)
    unless the block's chains would then need more than
    ``_build.MAX_THREADS`` threads, else the most that fit; at one lane a
    pair the block is checked as it is."""
    return next((gs for gs in LANES_A_PAIR if block_threads(
        p_block, m_block, pw, gs) <= _build.MAX_THREADS), 1)


def smem_bytes(progs: DevicePrograms, nin: int, p_block: int,
               m_block: int, ct: int, pw: int, gs: int) -> int:
    """Dynamic shared memory of one interpreter block (mirrors
    ``layout`` in the source): the ring's barriers, both programs, the
    256-row LUT3 mask table, two raw C tiles, the product ring, and a
    file of rows for each chain warp and each producer warp, a row one
    word a chain."""
    nch = padded_chains(p_block, m_block, gs)
    nout = progs.add.nout
    return (16 * STAGES + progs.program_bytes + 256 * 32
            + 4 * 2 * (m_block + p_block) * (ct * nin + 1)
            + 4 * STAGES * ct * nout * nch
            + 4 * progs.add.nrows * nch
            + 4 * pw * progs.mul.nrows * nch)


def ring_slot(progs: DevicePrograms, nin: int, p_block: int, m_block: int,
              c_block: int, k: int, pw: int, gs: int) -> int:
    """Channels of a ring slot: ``c_block`` rounded up to the chain depth
    (``_build.c_tile``), less whole chain steps while the block would not
    fit in shared memory.  Values never depend on it."""
    ct = _build.c_tile(c_block, k)
    while ct > k and smem_bytes(progs, nin, p_block, m_block, ct, pw,
                                gs) > _build.MAX_SMEM:
        ct -= k
    return ct


def launch(fn, i_masks, w_planes, out, progs: DevicePrograms, k: int,
           p_block: int, m_block: int, c_block: int, pw: int,
           probe=None, gs: int | None = None) -> None:
    """Launch ``fn`` (a bound C entry) on the current stream for a block
    of these parameters (lanes a pair ``gs``, by default
    :func:`lanes_a_pair`; the ring slot from :func:`ring_slot`), after
    checking it: raises before launching what the card would refuse.
    ``probe``: the probe entry's counter tensor."""
    P, C, nin = i_masks.shape
    Mw = w_planes.shape[2]
    gs = gs or lanes_a_pair(p_block, m_block, pw)
    ct = ring_slot(progs, nin, p_block, m_block, c_block, k, pw, gs)
    smem = smem_bytes(progs, nin, p_block, m_block, ct, pw, gs)
    _build.check_blocks(p_block, m_block, ct, smem,
                        threads=block_threads(p_block, m_block, pw, gs),
                        what=f"{progs.program_bytes} B of programs")
    args = [_build.ptr(i_masks), _build.ptr(w_planes), _build.ptr(out),
            _build.ptr(progs.blob), progs.meta, nin, progs.add.nout, k, P,
            C, Mw, p_block, m_block, ct, pw, gs, _build.stream_ptr()]
    if probe is not None:
        args.append(_build.ptr(probe))
    with torch.cuda.device(i_masks.device):
        code = fn(*args)
    _build.check(code, "bitslice_mac")


def bitslice_mac_cuda(i_masks: torch.Tensor, w_planes: torch.Tensor, *,
                      fmt: FPFormat, extended: bool = False,
                      rounding: str = RNE, c_unroll: int | None = None,
                      p_block: int | None = None,
                      m_block: int | None = None,
                      c_block: int | None = None):
    """HOBFLOPS GEMM in bit planes: i_masks [P, C, NIN] in {0, -1},
    w_planes [C, NIN, Mw] -> [NOUT, P, Mw] int32.

    On CUDA tensors this launches ``csrc/bitslice_mac.cu`` (blocks over
    ``m_block x p_block`` (row, lane word) chains, :func:`lanes_a_pair`
    lanes a pair of them, and ``_build.INTERP_PRODUCERS`` producer warps
    a chain warp; ring slots of ``c_block`` channels (:func:`ring_slot`);
    missing values from :func:`_build.launch_blocks`); on CPU tensors it
    runs the plain
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
    k = blk["c_unroll"]
    progs = device_programs(fmt, k, extended, rounding, LIB,
                            str(i_masks.device))
    out = torch.empty((progs.add.nout, P, Mw), dtype=torch.int32,
                      device=i_masks.device)
    launch(_launch_fn(), i_masks, w_planes, out, progs, k, blk["p_block"],
           blk["m_block"], blk["c_block"], _build.INTERP_PRODUCERS)
    bitslice_mac_cuda.launches += 1
    return out


bitslice_mac_cuda.launches = 0
