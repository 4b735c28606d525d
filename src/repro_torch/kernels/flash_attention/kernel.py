"""Blockwise attention as CUDA kernels, with their wrappers.

Replaces no TPU kernel: the reference computes ``_flash``
(``repro.models.attention``) with ``jnp`` in two nested scans, which XLA
fuses on the TPU.  On the card the scan is ``csrc/flash_attention.cu``:
one kernel for the forward (online softmax in registers, causal tiles
above the diagonal skipped), four for the backward (the Dv row dot,
dK/dV by key tile and run of query tiles, the runs' sum, dQ by query
tile; no atomics, so two calls give the same bits).

Two routes, chosen by the inputs' dtype (the flag :func:`_dims` passes
to the C entries), both exact in their products:

* bfloat16: Hopper tensor cores.  A bf16 x bf16 product is exact in
  float32, so q.k^T and dO.v^T are one bf16 ``wgmma`` each with f32
  accumulation.  P.v, P^T.dO, dS.k and dS^T.q have a float32 operand
  (P or dS), which the kernel splits exactly into three bf16 values
  (``ref.split_bf16``: hi + mid + lo = x): three ``wgmma``s reproduce
  the float32 products.  The sums differ from the plain version's in
  order and in ``wgmma``'s f32 accumulation, which does not round to
  nearest at each addition; ``chip_smoke.py`` holds the share of bf16
  outputs whose bits differ from the plain version's.  A 64 x 64 tile
  pair issues 4 bf16 half-products forward and 13 backward (the function
  needs 11: the dQ kernel recomputes S and dP); k and v tiles come by
  TMA (in the forward and dQ, into a ring of stages a producer warp
  fills).  Bounds on the H100: the half-products at 4096 bf16 FLOPs a
  clock an SM (989 TFLOP/s at 1830 MHz), ``exp`` at 16 a clock an SM,
  bytes at 3.35 TB/s.
* float32: float32 FFMA (the CPU-compute checks and float32 serving
  prefill reach it), bound by 66.9 TFLOP/s of FFMA.

A failure to build or launch raises; it never moves a call to the other
route or to the plain version.

Layouts (the ``shard_local`` layout of the port's attention):
    q      : [B, Sq, Hkv, G, D]  bfloat16 or float32
    k, v   : [B, Sk, Hkv, D]     q's type
    o      : [B, Sq, Hkv, G, D]  q's type
    lse    : [B, Sq, Hkv, G]     float32
Head sizes 16, 32, 64, 128 and 256.  The kernels' tiles are their own:
``q_block`` and ``kv_block`` fix only the plain version's order of
summation, and the wrappers take them for that version alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build

from .ref import flash_bwd_ref, flash_fwd_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def build_job() -> tuple[str, str]:
    """The ``(name, source)`` pair :func:`_build.build` compiles."""
    return "flash_attention", (_build.CSRC / "flash_attention.cu").read_text()


_BOUND: dict = {}


def load(library: _build.Library) -> None:
    """Bind the C entries of a built ``flash_attention`` library."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pi = ctypes.POINTER(ctypes.c_int)
    dims = [ci] * 9 + [cf]
    _BOUND["fwd"] = _build.bind(library.lib, "flash_fwd_launch",
                                [vp] * 5 + dims + [vp])
    _BOUND["bwd"] = _build.bind(library.lib, "flash_bwd_launch",
                                [vp] * 11 + dims + [pi, vp])
    _BOUND["workspace"] = _build.bind(library.lib, "flash_bwd_workspace",
                                      [ci] * 7, ctypes.c_long)


def _entry(name: str):
    if name not in _BOUND:
        load(_build.build([build_job()])[0])
    return _BOUND[name]


def _checked(q, k, v, *rest):
    """Contiguous CUDA operands on one device, q, k, v of one type, the
    head size one the kernels take; raises otherwise."""
    B, Sq, Hkv, G, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B \
            or k.shape[2] != Hkv or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if D not in HEAD_DIMS or q.dtype not in DTYPES \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes head sizes {HEAD_DIMS} in "
                         f"one of {DTYPES}: D={D}, {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    # Rows are loaded 16 bytes at a time: a view that starts off that
    # alignment is copied.
    ts = [t.contiguous() for t in (q, k, v, *rest)]
    ts = [t.clone() if t.data_ptr() % 16 else t for t in ts]
    if any(t.device != q.device or t.device.type != "cuda" for t in ts):
        raise ValueError(f"expected CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    return ts


def _dims(q, k, causal, q_offset):
    B, Sq, Hkv, G, D = q.shape
    return (B, Sq, k.shape[1], Hkv, G, D, int(causal), int(q_offset),
            int(q.dtype == torch.bfloat16), D ** -0.5)


def flash_fwd_cuda(q, k, v, *, causal: bool, q_block: int = 512,
                   kv_block: int = 512, q_offset: int = 0):
    """-> (o, lse).  On CUDA tensors this launches the forward kernel;
    on CPU tensors it runs the plain version."""
    if q.device.type == "cpu" and k.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, q_block=q_block,
                             kv_block=kv_block, q_offset=q_offset)
    q, k, v = _checked(q, k, v)
    if q.numel() == 0 or k.shape[1] == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:4], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _entry("fwd")(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                             _build.ptr(o), _build.ptr(lse),
                             *_dims(q, k, causal, q_offset),
                             _build.stream_ptr())
    _build.check(code, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return o, lse


def flash_bwd_cuda(do, q, k, v, o, lse, *, causal: bool, q_block: int = 512,
                   kv_block: int = 512, q_offset: int = 0):
    """-> (dq, dk, dv) in the inputs' type.  On CUDA tensors this
    launches the four backward kernels: the Dv pass, dK/dV over runs of
    query tiles, the sum of the runs' partial results, and dQ
    (``launches`` counts calls, ``kernel_launches`` the kernels); on CPU
    tensors it runs the plain version."""
    if q.device.type == "cpu" and k.device.type == "cpu":
        return flash_bwd_ref(do, q, k, v, o, lse, causal=causal,
                             q_block=q_block, kv_block=kv_block,
                             q_offset=q_offset)
    q, k, v, o, lse, do = _checked(q, k, v, o, lse, do.to(q.dtype))
    if o.shape != q.shape or lse.shape != q.shape[:4] \
            or lse.dtype != torch.float32:
        raise ValueError(f"o {tuple(o.shape)} / lse {tuple(lse.shape)} "
                         f"{lse.dtype} do not fit q {tuple(q.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dvec = torch.empty(q.shape[:4], dtype=torch.float32, device=q.device)
    B, Sq, Hkv, G, D = q.shape
    part = torch.empty(_entry("workspace")(B, Sq, k.shape[1], Hkv, G, D,
                                           int(q.dtype == torch.bfloat16)),
                       dtype=torch.float32, device=q.device)
    n = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        code = _entry("bwd")(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                             _build.ptr(o), _build.ptr(do), _build.ptr(lse),
                             _build.ptr(dvec), _build.ptr(part),
                             _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
                             *_dims(q, k, causal, q_offset),
                             ctypes.byref(n), _build.stream_ptr())
    _build.check(code, "flash_bwd")
    flash_bwd_cuda.launches += 1
    flash_bwd_cuda.kernel_launches += n.value
    return dq, dk, dv


# Calls that launched; the backward launches four CUDA kernels a call.
flash_fwd_cuda.launches = 0
flash_bwd_cuda.launches = 0
flash_bwd_cuda.kernel_launches = 0
