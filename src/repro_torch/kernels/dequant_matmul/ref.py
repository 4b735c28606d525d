"""Plain torch version of the fused dequant matmul."""
from __future__ import annotations

import torch

from repro_torch.core import softfloat as sf
from repro_torch.core.bitslice import unpack_planes
from repro_torch.core.fpformat import StorageFormat


def dequant_matmul_ref(x, planes, scale, sfmt: StorageFormat,
                       N: int) -> torch.Tensor:
    """x [M,K], planes [nbits,K,N//32] int32 -> [M,N] f32 (unfused):
    decode every weight (as ``quant.dequantize`` does, subnormals
    flushed), then one float32 matmul with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    nbits, K, Nw = planes.shape
    codes = unpack_planes(planes.reshape(nbits, K * Nw))  # [K*Nw*32]
    codes = codes.reshape(K, Nw * 32)[:, :N]
    w = sf.flush_subnormal(
        sf.flush_subnormal(sf.decode_storage(codes, sfmt)) * scale)
    return x.to(torch.float32) @ w
