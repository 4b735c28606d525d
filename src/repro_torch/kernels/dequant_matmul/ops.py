"""Public API for the fused bitplane-dequant matmul."""
from __future__ import annotations

import torch

from repro_torch.core.fpformat import StorageFormat
from repro_torch.quant.storage import LANE, QuantizedTensor, quantize

from .kernel import dequant_matmul_cuda
from .ref import dequant_matmul_ref


def pack_weights(w, sfmt: StorageFormat) -> QuantizedTensor:
    """[K, N] float weights -> bitplane QuantizedTensor with the 2-D
    [nbits, K, N//32] layout the kernel streams (N % 32 == 0)."""
    w = torch.as_tensor(w)
    K, N = w.shape
    if N % LANE:
        raise ValueError(f"N={N} must be a multiple of {LANE}")
    qt = quantize(w, sfmt, layout="bitplane")
    data = qt.data.reshape(qt.data.shape[0], K, N // LANE)
    return QuantizedTensor(data=data, scale=qt.scale, sfmt=sfmt,
                           layout="bitplane2d", shape=(K, N))


def dequant_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                   backend: str = "cuda") -> torch.Tensor:
    """x [M, K] @ dequant(qt [K, N]) -> [M, N] f32.

    ``backend="cuda"`` launches the kernel on CUDA tensors (its wrapper
    runs the plain version on CPU tensors); ``backend="torch"`` is the
    plain version and takes CPU tensors only."""
    K, N = qt.shape
    if backend == "cuda":
        return dequant_matmul_cuda(x, qt.data, qt.scale, qt.sfmt, N=N)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    if x.device.type != "cpu" or qt.data.device.type != "cpu":
        raise ValueError("backend='torch' is the plain version and runs on "
                         "CPU tensors only; use backend='cuda' on the card")
    return dequant_matmul_ref(x, qt.data, qt.scale, qt.sfmt, N)
