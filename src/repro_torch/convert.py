"""Carry the JAX package's parameters across as numpy.

Both packages encode the same f32 kernels to the same bit planes; these
helpers wrap planes produced by the reference (``np.asarray`` of its
``ConvWeights.planes``) as the port's :class:`ConvWeights`, and an LM
parameter tree (``jax.tree.map(np.asarray, params)``) as the port's
tree, so a test can feed both packages identical parameters; a train
state (parameters, AdamW moments, step) likewise.  Nothing here imports
the reference: everything arrives as plain arrays (bfloat16 ones as
``ml_dtypes`` arrays, whose bytes are carried across unchanged).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._build import resolve_device
from repro_torch.core.fpformat import FPFormat, StorageFormat
from repro_torch.kernels.conv2d_bitslice.ops import ConvWeights
from repro_torch.quant.storage import QuantizedTensor


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


def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a CPU tensor of its dtype."""
    a = np.array(a)                                  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_jax(tree, device="cuda"):
    """A reference LM parameter tree as numpy -> the port's tree on
    ``device``.  Dicts keep their keys; arrays become tensors; a
    quantized leaf arrives as ``(data, scale, (w_e, w_f), layout,
    shape)`` and becomes a :class:`QuantizedTensor`."""
    device = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple):
            data, scale, (w_e, w_f), layout, shape = t
            return QuantizedTensor(
                data=torch.from_numpy(np.array(data)).to(device),
                scale=torch.from_numpy(np.array(scale, np.float32))
                .to(device),
                sfmt=StorageFormat(w_e, w_f), layout=layout,
                shape=tuple(shape))
        return _tensor(t).to(device)

    return walk(tree)


def train_state_from_jax(state, device="cuda"):
    """A reference train state as numpy (``{"params", "opt": {"m", "v"},
    "step"}``) -> the port's, on ``device``: the step a 0-d int32
    tensor, moments in their own dtype."""
    return {"params": lm_params_from_jax(state["params"], device),
            "opt": {k: lm_params_from_jax(state["opt"][k], device)
                    for k in ("m", "v")},
            "step": _tensor(np.asarray(state["step"], np.int32)).to(
                resolve_device(device))}
