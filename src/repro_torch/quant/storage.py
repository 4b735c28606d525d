"""Quantized weight tensors: HOBFLOPS codes in native or bitplane layout."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import softfloat as sf
from repro_torch.core.bitslice import pack_planes, unpack_planes
from repro_torch.core.fpformat import RNE, StorageFormat

LANE = 32


@dataclasses.dataclass
class QuantizedTensor:
    """A weight tensor stored as HOBFLOPS StorageFormat codes.

    layout "native":     data is int8/int16 with `shape`.
    layout "bitplane":   data is int32 [nbits, prod(shape)/32] bit planes.
    layout "bitplane2d": data is int32 [nbits, K, N/32] bit planes of a
                         [K, N] matrix (the layout the dequant matmul
                         kernel streams).
    A stacked tensor (one per layer) carries a leading depth axis on
    ``data`` and ``scale``; ``shape`` is always one layer's shape.
    """
    data: torch.Tensor
    scale: torch.Tensor   # f32 per-tensor scale, 0-d (or [depth])
    sfmt: StorageFormat
    layout: str
    shape: tuple

    @property
    def dtype(self):
        return torch.float32

    def nbytes_hbm(self) -> int:
        return storage_bytes(self.shape, self.sfmt, self.layout)

    def layer(self, i: int) -> "QuantizedTensor":
        """Layer ``i`` of a stacked tensor."""
        return dataclasses.replace(self, data=self.data[i],
                                   scale=self.scale[i])


def storage_bytes(shape, sfmt: StorageFormat, layout: str) -> int:
    n = math.prod(shape)
    if layout == "native":
        return n * (1 if sfmt.container() == "int8" else 2)
    return -(-n * sfmt.nbits // 8)  # true bit packing


def quantize(w, sfmt: StorageFormat, layout: str = "native",
             rounding: str = RNE, scale=None) -> QuantizedTensor:
    """Quantize float weights.  `scale` defaults to amax-based so the
    largest weight maps near the top of the format's range.  Subnormals
    flush to zero as in the reference (``softfloat.flush_subnormal``)."""
    w = sf.flush_subnormal(torch.as_tensor(w).to(torch.float32))
    if scale is None:
        amax = torch.clamp(w.abs().max(), min=1e-30)
        # place amax at ~half the max representable magnitude
        target = 2.0 ** (sfmt.emax - sfmt.bias - 1)
        scale = amax / target
    scale = sf.flush_subnormal(
        torch.as_tensor(scale, dtype=torch.float32, device=w.device))
    codes = sf.encode_storage(w / scale, sfmt, rounding)
    if layout == "native":
        ct = torch.int8 if sfmt.container() == "int8" else torch.int16
        data = codes.to(ct)
    elif layout == "bitplane":
        data = pack_planes(codes.reshape(-1), sfmt.nbits)  # [nbits, n/32]
    else:
        raise ValueError(layout)
    return QuantizedTensor(data=data, scale=scale, sfmt=sfmt,
                           layout=layout, shape=tuple(w.shape))


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """-> float32 tensor of qt.shape (the plain decode path; subnormal
    values and products flush to zero, as in the reference)."""
    n = math.prod(qt.shape)
    if qt.layout == "native":
        codes = qt.data.to(torch.int32)
    elif qt.layout == "bitplane2d":
        # [nbits, K, N//32] planes
        nbits, K, Nw = qt.data.shape
        codes = unpack_planes(qt.data.reshape(nbits, K * Nw))
        codes = codes.reshape(K, Nw * LANE)
    else:
        codes = unpack_planes(qt.data)[:n].reshape(qt.shape)
    vals = sf.flush_subnormal(sf.decode_storage(codes, qt.sfmt))
    return sf.flush_subnormal(vals.reshape(qt.shape) * qt.scale)
