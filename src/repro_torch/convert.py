"""Carry the JAX package's encoded conv weights across as numpy.

Both packages encode the same f32 kernels to the same bit planes; these
helpers wrap planes produced by the reference (``np.asarray`` of its
``ConvWeights.planes``) as the port's :class:`ConvWeights`, so a test
can feed both packages identical parameters.  Nothing here imports the
reference: the planes arrive as plain arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fpformat import FPFormat
from repro_torch.kernels.conv2d_bitslice.ops import ConvWeights, resolve_device


def conv_weights_from_jax(planes: np.ndarray, kh: int, kw: int, cin: int,
                          cout: int, w_e: int, w_f: int,
                          device="cuda") -> ConvWeights:
    """``[kh*kw*cin, NIN, Mw]`` int32 planes -> :class:`ConvWeights`."""
    fmt = FPFormat(w_e, w_f)
    planes = np.array(planes, dtype=np.int32)        # a writable copy
    if planes.shape[:2] != (kh * kw * cin, fmt.nbits) or \
            planes.shape[2] * 32 < cout:
        raise ValueError(f"planes {planes.shape} do not fit a "
                         f"{kh}x{kw}x{cin}->{cout} {fmt} kernel")
    return ConvWeights(torch.from_numpy(planes).to(resolve_device(device)),
                       kh, kw, cin, cout, fmt)


def graph_weights_from_jax(weights: dict, device="cuda") -> dict:
    """``{node: (planes, (kh, kw, cin, cout, w_e, w_f))}`` ->
    ``{node: ConvWeights}``, ready for ``NetworkGraph.conv``."""
    return {name: conv_weights_from_jax(planes, *geometry, device=device)
            for name, (planes, geometry) in weights.items()}
