"""Apply HOBFLOPS weight quantization to a model parameter tree.

Targets every >=2D projection matrix in the transformer blocks (plus
logits head and modality projector); embeddings, norms and biases stay
in full precision.  Stacked weights (one slice per layer) are packed PER
LAYER so that the layer loop can slice the leading depth axis of the
bitplane tensor — the QuantizedTensor's ``shape`` records the per-layer
shape.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.fpformat import StorageFormat, parse_format

from .storage import LANE, QuantizedTensor, dequantize, quantize

# weight names eligible for quantized storage
_TARGETS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
            "in_proj", "out_proj", "w"}
_SKIP_PARENTS = {"embed"}


def _sfmt(fmt_name: str) -> StorageFormat:
    f = parse_format(fmt_name)
    return StorageFormat(f.w_e, f.w_f)


def quantize_leaf(w, sfmt: StorageFormat, stacked: bool) -> QuantizedTensor:
    """Quantize one tensor; if `stacked`, pack each leading-axis slice
    separately so per-layer slicing stays valid."""
    if not stacked:
        return quantize(w, sfmt, layout="bitplane")
    per = [quantize(w[i], sfmt, layout="bitplane")
           for i in range(w.shape[0])]
    return QuantizedTensor(
        data=torch.stack([q.data for q in per]),
        scale=torch.stack([q.scale for q in per]),
        sfmt=sfmt, layout="bitplane", shape=tuple(w.shape[1:]))


def _plane2d_shape(shape, sfmt: StorageFormat):
    """Bitplane-2D layout: [..., K, N] -> [..., nbits, K, N // 32]."""
    *lead, K, N = shape
    if N % LANE:
        raise ValueError(f"N = {N} is not a multiple of {LANE}")
    return tuple(lead) + (sfmt.nbits, K, N // LANE)


def abstract_quantize_params(abstract_params, cfg, fmt_name: str):
    """Meta-tensor tree -> same tree with target weights replaced by
    abstract QuantizedTensors (bitplane-2D, shardable along K and
    N//32).  Used by the dry run: nothing is allocated."""
    sfmt = _sfmt(fmt_name)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        name = path[-1] if path else ""
        parent = path[-2] if len(path) > 1 else ""
        in_blocks = any(p in ("blocks", "enc_blocks", "logits", "frontend")
                        for p in path)
        if (in_blocks and name in _TARGETS
                and parent not in _SKIP_PARENTS
                and len(tree.shape) >= 2 and tree.shape[-1] % LANE == 0):
            lead = tuple(tree.shape[:-2])
            return QuantizedTensor(
                data=torch.empty(_plane2d_shape(tree.shape, sfmt),
                                 dtype=torch.int32, device="meta"),
                scale=torch.empty(lead, dtype=torch.float32, device="meta"),
                sfmt=sfmt, layout="bitplane2d",
                shape=tuple(tree.shape[-2:]))
        return tree

    return walk(abstract_params, ())


def quantized_pspecs(pspec_tree, qparams_tree):
    """Map the dense-param PartitionSpec tree onto the quantized tree:
    a leaf spec (*lead, K_ax, N_ax) becomes data (*lead, None, K_ax,
    N_ax) (planes replicated, K/N//32 inherit) and scale (*lead,)."""
    from repro_torch.models.schema import PartitionSpec

    def walk(spec, q):
        if isinstance(q, dict):
            return {k: walk(spec[k], q[k]) for k in q}
        if isinstance(q, QuantizedTensor):
            parts = list(spec)
            parts += [None] * (len(q.data.shape) - 1 - len(parts))
            lead, k_ax, n_ax = parts[:-2], parts[-2], parts[-1]
            return QuantizedTensor(
                data=PartitionSpec(*lead, None, k_ax, n_ax),
                scale=PartitionSpec(*lead),
                sfmt=q.sfmt, layout=q.layout, shape=q.shape)
        return spec

    return walk(pspec_tree, qparams_tree)


def quantize_params(params, cfg, fmt_name: str):
    """-> (new_params, deq_hook).  Weights under blocks/enc_blocks (and
    the logits/frontend heads) move to bitplane storage."""
    sfmt = _sfmt(fmt_name)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        name = path[-1] if path else ""
        parent = path[-2] if len(path) > 1 else ""
        in_blocks = any(p in ("blocks", "enc_blocks", "logits", "frontend")
                        for p in path)
        if (in_blocks and name in _TARGETS
                and parent not in _SKIP_PARENTS
                and isinstance(tree, torch.Tensor) and tree.ndim >= 2
                and math.prod(tree.shape[-2:]) % LANE == 0):
            stacked = any(p.startswith("b") and p[1:].isdigit()
                          for p in path) or "e0" in path
            stacked = stacked and tree.ndim >= 3
            return quantize_leaf(tree, sfmt, stacked)
        return tree

    new_params = walk(params, ())
    return new_params, make_deq()


def make_deq():
    """The dequant hook the layers call: (name, maybe-quantized) ->
    dense tensor."""
    def deq(name, x):
        if isinstance(x, QuantizedTensor):
            return dequantize(x)
        return x
    return deq


def quantized_bytes(params) -> tuple[int, int]:
    """(bytes_quantized_storage, bytes_if_bf16) over quantized leaves."""
    q_bytes = 0
    d_bytes = 0

    def walk(tree):
        nonlocal q_bytes, d_bytes
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, QuantizedTensor):
            n_layers = (tree.data.shape[0] if tree.data.ndim == 3 else 1)
            q_bytes += tree.data.numel() * 4 + tree.scale.numel() * 4
            d_bytes += n_layers * math.prod(tree.shape) * 2
    walk(params)
    return q_bytes, d_bytes
