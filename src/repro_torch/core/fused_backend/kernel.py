"""The fused MAC-chain CUDA kernel and its plain torch version.

Port of ``repro.core.pallas_backend.kernel.fused_mac_pallas``: one
launch carries the whole layer — the netlists emitted as straight-line
CUDA (:mod:`.emitter`), the channel reduction as a loop inside the
block, and the ReLU epilogue after it (``csrc/fused_mac.cuh``, whose
header note says what bounds it on the H100).  Producer warps run the
multiplier (:func:`fused_mul_lowered`) ahead of the chain warps, which
run the add-only chain (:func:`fused_add_lowered`); the plain version
runs the whole MAC chain (:func:`fused_chain_lowered`).

Each (format, chain depth, extended, rounding, relu) variant is a C
entry ``fused_mac_<tag>`` generated into one source; :func:`build_job`
puts every variant a run needs into a single ``nvcc`` call.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib

import torch

from repro_torch import _build
from repro_torch.core.fpcore import build_mac_chain
from repro_torch.core.fpformat import RNE, FPFormat
from repro_torch.core.opt import optimize_mapped

from .emitter import LoweredNetlist, lower_netlist
from .netlists import build_add_chain, build_mul_step

# The chain body's depth: the deepest of at most FUSED_DEPTH steps whose
# body holds at most GATE_BUDGET gates.  Timed over both conv layers of
# the MobileNets stage (scripts/torch_fused_regfile.py), that is the
# fastest depth of hobflops8 (k=4, 960 gates), 9 (k=4, 1046), 11 (k=3,
# 961) and 16 (k=2, 878); no depth spills.
FUSED_DEPTH = 4
GATE_BUDGET = 1100


@functools.lru_cache(maxsize=None)
def fused_chain_lowered(fmt: FPFormat, k: int, extended: bool,
                        rounding: str, lib: str = "avx512"
                        ) -> LoweredNetlist:
    """The optimized ``lib``-mapped K-step MAC chain, lowered once per
    (format, chain depth, rounding).  ``avx512`` is the 3-input LUT3
    cell library, which is Hopper's ``LOP3``."""
    mapped = optimize_mapped(build_mac_chain(fmt, k, extended, rounding),
                             lib)
    return lower_netlist(mapped)


@functools.lru_cache(maxsize=None)
def fused_add_lowered(fmt: FPFormat, k: int, extended: bool,
                      rounding: str) -> LoweredNetlist:
    """The optimized avx512-mapped k-step add-only chain over products
    (:func:`.netlists.build_add_chain`), lowered once."""
    return lower_netlist(optimize_mapped(
        build_add_chain(fmt, k, extended, rounding), "avx512"))


@functools.lru_cache(maxsize=None)
def fused_mul_lowered(fmt: FPFormat, extended: bool,
                      rounding: str) -> LoweredNetlist:
    """The optimized avx512-mapped multiplier into the accumulator
    format (:func:`.netlists.build_mul_step`), lowered once."""
    return lower_netlist(optimize_mapped(
        build_mul_step(fmt, extended, rounding), "avx512"))


def fused_chain_k(fmt: FPFormat, extended: bool = False,
                  requested: int = _build.CHAIN_DEPTH,
                  rounding: str = RNE) -> int:
    """Chain depth the fused backend actually uses: ``requested`` capped
    at ``FUSED_DEPTH``, less one while the chain warps' add-only body has
    more than ``GATE_BUDGET`` gates.  Chain depth never changes values."""
    k = min(requested, FUSED_DEPTH)
    while k > 1 and fused_add_lowered(fmt, k, extended,
                                      rounding).gate_count() > GATE_BUDGET:
        k -= 1
    return k


def fused_variant(fmt: FPFormat, C: int, extended: bool = False,
                  rounding: str = RNE, relu: bool = False,
                  c_unroll: int | None = None) -> tuple:
    """The ``(fmt, k, extended, rounding, relu)`` variant that
    :func:`fused_mac_cuda` launches for ``C`` channels — what to build
    ahead of a run (``NetworkGraph.fused_variants``)."""
    k = fused_chain_k(fmt, extended, _build.chain_depth(C, c_unroll),
                      rounding)
    return (fmt, k, extended, rounding, relu)


def variant_tag(fmt: FPFormat, k: int, extended: bool, rounding: str,
                relu: bool) -> str:
    ext = "x" if extended else "s"
    return (f"e{fmt.w_e}m{fmt.w_f}{ext}_k{k}_{rounding}"
            f"{'_relu' if relu else ''}")


def fused_source(variants, probe: bool = False) -> str:
    """CUDA source holding one C entry per ``(fmt, k, extended,
    rounding, relu)`` variant; bodies are shared across variants.
    ``probe`` adds each variant's measurement-only ``clock64`` entry
    ``fused_mac_probe_<tag>`` (``scripts/torch_fused_probe.py``)."""
    variants = sorted(set(variants), key=lambda v: variant_tag(*v))
    parts = ['#include "fused_mac.cuh"', ""]
    seen = set()

    def body(name, lowered, fmt, extended):
        if name not in seen:
            seen.add(name)
            parts.append(lowered.cuda_body(
                name, SIGN_OFF=fmt.mult_out(extended).sign_off))
        return name

    for fmt, k, extended, rounding, relu in variants:
        chain = body("Add_" + variant_tag(fmt, k, extended, rounding,
                                          False),
                     fused_add_lowered(fmt, k, extended, rounding), fmt,
                     extended)
        mul = body("Mul_" + variant_tag(fmt, 1, extended, rounding, False),
                   fused_mul_lowered(fmt, extended, rounding), fmt,
                   extended)
        tag = variant_tag(fmt, k, extended, rounding, relu)
        args = f"{chain}, {mul}, {'true' if relu else 'false'}"
        parts.append(f"HF_DEFINE_FUSED_LAUNCH(fused_mac_{tag}, {args})")
        if probe:
            parts.append(f"HF_DEFINE_FUSED_PROBE(fused_mac_probe_{tag}, "
                         f"{args})")
    return "\n".join(parts) + "\n"


def build_job(variants, probe: bool = False) -> tuple[str, str]:
    """The ``(name, source)`` pair :func:`_build.build` compiles for
    these variants (with their probe entries if ``probe``)."""
    src = fused_source(variants, probe)
    return f"fused_mac_{hashlib.sha256(src.encode()).hexdigest()[:8]}", src


# Bound C entries by variant, once a library holding them is loaded.
_BOUND: dict = {}


def load(library: _build.Library, variants) -> None:
    """Bind the entries of a library built from :func:`build_job`."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for v in variants:
        _BOUND[v] = _build.bind(library.lib, f"fused_mac_{variant_tag(*v)}",
                                [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp])


def is_bound(variant) -> bool:
    """True once a loaded library's entry for ``variant`` is bound."""
    return variant in _BOUND


def _launch_fn(variant):
    if variant not in _BOUND:
        load(_build.build([build_job([variant])])[0], [variant])
    return _BOUND[variant]


def smem_bytes(nin: int, nout: int, p_block: int, m_block: int,
               c_block: int) -> int:
    """Dynamic shared memory of one fused block (mirrors
    ``fused_mac_smem_bytes`` in the header): the ring's barriers, two
    C-tile slots of staged words and the ring of product planes."""
    stages, lanes = 3, -(-p_block * m_block // 32) * 32
    raw = (m_block + p_block) * (c_block * nin + 1)
    return 16 * stages + 4 * (2 * raw + stages * lanes *
                              (c_block * nout + 1))


def block_threads(p_block: int, m_block: int) -> int:
    """Threads of one fused block: the chain warps over
    ``p_block x m_block`` (row, lane word) chains and
    ``_build.FUSED_PRODUCERS`` producer warps for each."""
    return (1 + _build.FUSED_PRODUCERS) * (-(-p_block * m_block // 32) * 32)


def ring_slot(c_block: int, k: int, nin: int, nout: int, p_block: int,
              m_block: int) -> int:
    """Channels of a ring slot: ``c_block`` rounded up to the chain depth
    (``_build.c_tile``), less whole chain steps while the block's ring
    would not fit in shared memory.  Values never depend on it."""
    ct = _build.c_tile(c_block, k)
    while ct > k and smem_bytes(nin, nout, p_block, m_block,
                                ct) > _build.MAX_SMEM:
        ct -= k
    return ct


def _fused_mac_torch(i_masks, w_planes, *, fmt: FPFormat, extended: bool,
                     rounding: str, k: int, relu: bool):
    """Plain version: the lowered body as a torch body over
    C/k channel groups (C zero-padded to a multiple of k, the MAC
    identity), then the ReLU epilogue."""
    P, C, nin = i_masks.shape
    Mw = w_planes.shape[2]
    lowered = fused_chain_lowered(fmt, k, extended, rounding)
    fmt_out = fmt.mult_out(extended)
    acc = torch.zeros((fmt_out.nbits, P, Mw), dtype=torch.int32,
                      device=i_masks.device)
    zeros_c = torch.zeros((nin, 1, Mw), dtype=torch.int32,
                          device=i_masks.device)
    zeros_p = torch.zeros((nin, P, 1), dtype=torch.int32,
                          device=i_masks.device)
    for s in range(0, C, k):
        kwargs = {"acc": acc}
        for j in range(k):
            c = s + j
            kwargs[f"x{j}"] = w_planes[c][:, None, :] if c < C else zeros_c
            kwargs[f"y{j}"] = i_masks[:, c, :].T[:, :, None] \
                if c < C else zeros_p
        acc = lowered(**kwargs)["out"].expand(acc.shape)
    if relu:
        acc = acc & ~acc[fmt_out.sign_off][None]
    return acc.contiguous()


def fused_mac_cuda(i_masks: torch.Tensor, w_planes: torch.Tensor, *,
                   fmt: FPFormat, extended: bool = False,
                   rounding: str = RNE, c_unroll: int | None = None,
                   relu: bool = False, p_block: int | None = None,
                   m_block: int | None = None, c_block: int | None = None):
    """Fused HOBFLOPS GEMM in bit planes with the optional ReLU
    epilogue: i_masks [P, C, NIN] in {0, -1}, w_planes [C, NIN, Mw] ->
    [NOUT, P, Mw] int32, one launch of :func:`fused_variant`'s variant
    with blocks from :func:`_build.launch_blocks` (``p_block x m_block``
    chain threads and as many producer threads).  CPU tensors run the
    plain version; any shape is accepted and the output never depends
    on the blocks."""
    P, C, nin = i_masks.shape
    C2, nin2, Mw = w_planes.shape
    if (C, nin) != (C2, nin2) or nin != fmt.nbits:
        raise ValueError(f"bad operand shapes {tuple(i_masks.shape)} x "
                         f"{tuple(w_planes.shape)} for {fmt}")
    variant = fused_variant(fmt, C, extended, rounding, relu, c_unroll)
    k = variant[1]
    if i_masks.device.type == "cpu" and w_planes.device.type == "cpu":
        return _fused_mac_torch(i_masks, w_planes, fmt=fmt,
                                extended=extended, rounding=rounding, k=k,
                                relu=relu)
    _build.require_cuda(i_masks, w_planes)
    blk = _build.launch_blocks(P, C, Mw, p_block=p_block, m_block=m_block,
                               c_block=c_block, kernel="fused_mac")
    p_block, m_block = blk["p_block"], blk["m_block"]
    nout = fmt.mult_out(extended).nbits
    ct = ring_slot(blk["c_block"], k, nin, nout, p_block, m_block)
    smem = smem_bytes(nin, nout, p_block, m_block, ct)
    _build.check_blocks(p_block, m_block, ct, smem,
                        threads=block_threads(p_block, m_block))
    fn = _launch_fn(variant)
    out = torch.empty((nout, P, Mw), dtype=torch.int32,
                      device=i_masks.device)
    with torch.cuda.device(i_masks.device):
        code = fn(_build.ptr(i_masks), _build.ptr(w_planes), _build.ptr(out),
                  P, C, Mw, p_block, m_block, ct, _build.FUSED_PRODUCERS,
                  _build.stream_ptr())
    _build.check(code, "fused_mac")
    fused_mac_cuda.launches += 1
    return out


fused_mac_cuda.launches = 0
