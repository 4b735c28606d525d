"""Public API for the HOBFLOPS bitslice MAC.

``hobflops_matmul``: float32 in / float32 out GEMM whose arithmetic is
custom-precision HOBFLOPS FP executed bitslice-parallel.  Backends:

* ``backend="cuda"``       — the netlist-interpreter CUDA kernel
                             (``bitslice_mac_cuda``).
* ``backend="cuda_fused"`` — the fused straight-line CUDA kernel
                             (``repro_torch.core.fused_backend``).
* ``backend="torch"``      — the interpreter's plain version, one torch
                             op per gate; CPU tensors only.

The CUDA backends run their plain versions when given CPU tensors.  All
produce bit-identical results; tests cross-check them, the JAX package
and the pure softfloat oracle in ref.py.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import softfloat as sf
from repro_torch.core.bitslice import pack_planes, unpack_planes
from repro_torch.core.fpformat import RNE, FPFormat
from repro_torch.core.fused_backend import fused_mac_cuda

from .kernel import _bitslice_mac_torch, bitslice_mac_cuda

LANE = 32
BACKENDS = ("torch", "cuda", "cuda_fused")


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult``."""
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths)


def encode_input_masks(i_f32: torch.Tensor, fmt: FPFormat,
                       rounding: str = RNE) -> torch.Tensor:
    """float32 [P,C] -> i_masks [P,C,NIN] int32 in {0,-1} (bit
    broadcast masks)."""
    ic = sf.encode_torch(i_f32, fmt, rounding)        # [P, C] int32
    shifts = torch.arange(fmt.nbits, dtype=torch.int32, device=ic.device)
    return -((ic[..., None] >> shifts) & 1)            # 0 / -1 masks


def encode_weight_planes(w_f32: torch.Tensor, fmt: FPFormat,
                         rounding: str = RNE) -> torch.Tensor:
    """float32 [C,M] -> w_planes [C,NIN,Mw] int32 bit planes (M packed
    along int32 lanes, padded to the next lane word).  Static inference
    weights should be encoded once through this and passed to
    ``hobflops_matmul(w_planes=...)`` /
    ``conv2d_bitslice.encode_conv_weights``."""
    wc = sf.encode_torch(w_f32, fmt, rounding)        # [C, M] int32
    return pack_planes(wc, fmt.nbits).movedim(0, 1).contiguous()


def encode_inputs(i_f32, w_f32, fmt: FPFormat, rounding: str = RNE):
    """float32 [P,C] x [C,M] -> (i_masks [P,C,NIN], w_planes [C,NIN,Mw])."""
    return (encode_input_masks(i_f32, fmt, rounding),
            encode_weight_planes(w_f32, fmt, rounding))


def mac_planes(i_masks: torch.Tensor, w_planes: torch.Tensor, *,
               fmt: FPFormat, backend: str, extended: bool = False,
               rounding: str = RNE, relu: bool = False,
               blocks: dict | None = None) -> torch.Tensor:
    """Dispatch the plane-domain GEMM to ``backend`` (with the ReLU
    epilogue fused for ``cuda_fused``, applied after the kernel
    otherwise).  ``backend="torch"`` on a CUDA tensor raises: the plain
    version is never the main path on the card."""
    blk = blocks or {}
    if backend == "cuda_fused":
        return fused_mac_cuda(i_masks, w_planes, fmt=fmt, extended=extended,
                              rounding=rounding, relu=relu, **blk)
    if backend == "cuda":
        out = bitslice_mac_cuda(i_masks, w_planes, fmt=fmt,
                                extended=extended, rounding=rounding, **blk)
    elif backend == "torch":
        if i_masks.device.type != "cpu":
            raise ValueError("backend='torch' is the plain version for CPU "
                             "tensors; use 'cuda' or 'cuda_fused' on the "
                             "card")
        out = _bitslice_mac_torch(i_masks, w_planes, fmt=fmt,
                                  extended=extended, rounding=rounding,
                                  c_unroll=blk.get("c_unroll"))
    else:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if relu:
        sign = out[fmt.mult_out(extended).sign_off]
        out = out & ~sign[None]
    return out


def hobflops_matmul(i_f32: torch.Tensor, w_f32: torch.Tensor | None = None,
                    *, fmt: FPFormat, w_planes: torch.Tensor | None = None,
                    cout: int | None = None, extended: bool = False,
                    rounding: str = RNE, backend: str = "cuda_fused",
                    blocks: dict | None = None) -> torch.Tensor:
    """GEMM [P,C] @ [C,M] -> [P,M] float32, in HOBFLOPS arithmetic, on
    the device of ``i_f32``.

    Weights are given either as float32 ``w_f32`` [C,M] (encoded to bit
    planes on every call) or pre-encoded ``w_planes`` [C,NIN,Mw] from
    :func:`encode_weight_planes` (``cout`` recovers M when it is not a
    full lane-word multiple).  ``blocks`` overrides the launch blocks
    (p_block / m_block / c_block / c_unroll).
    """
    P, C = i_f32.shape
    if w_planes is None:
        C2, M = w_f32.shape
        w_planes = encode_weight_planes(w_f32, fmt, rounding)
    else:
        if w_f32 is not None:
            raise ValueError("pass either w_f32 or w_planes, not both")
        C2, nin, Mw = w_planes.shape
        M = cout if cout is not None else Mw * LANE
        if nin != fmt.nbits or M > Mw * LANE:
            raise ValueError(f"w_planes {tuple(w_planes.shape)} do not "
                             f"match {fmt} with cout={M}")
    if C != C2:
        raise ValueError(f"reduction dims differ: {C} vs {C2}")
    i_masks = encode_input_masks(i_f32, fmt, rounding)
    out = mac_planes(i_masks, w_planes, fmt=fmt, backend=backend,
                     extended=extended, rounding=rounding, blocks=blocks)
    codes = unpack_planes(out)                       # [P, Mw*32]
    return sf.decode_torch(codes, fmt.mult_out(extended))[:P, :M]


def hobflops_quantize(x_f32: torch.Tensor, fmt: FPFormat,
                      rounding: str = RNE) -> torch.Tensor:
    """Round-trip float32 through the HOBFLOPS format (fake-quant)."""
    return sf.decode_torch(sf.encode_torch(x_f32, fmt, rounding), fmt)
