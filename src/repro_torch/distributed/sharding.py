"""PartitionSpec derivation for every tree a step takes, and its DTensor
placements.

Parameters (and optimizer moments) take their specs from the schema's
logical axes.  Batches shard their leading batch dim over the data(+pod)
axes.  Caches are matched structurally by leaf name: KV caches shard
batch over data and heads over model, falling back to sequence sharding
over "data" when batch is too small to split (the long-context decode
cells).

``named`` turns a spec into DTensor placements, one a mesh dimension:
``Shard(d)`` where the entry of tensor dimension ``d`` names that mesh
axis, ``Replicate()`` elsewhere and on an axis of size 1 (which splits
nothing, and so spares DTensor the strided layouts that flattening two
sharded dims makes).  Where one tensor dimension takes
several mesh axes, DTensor splits it in mesh-dimension order, which is
the spec's major-to-minor order only while the spec lists them in mesh
order: ``named`` checks that instead of assuming it.
``distribute_tree`` is the counterpart of ``jax.device_put(tree,
named(...))``.
"""
from __future__ import annotations

import dataclasses

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import (PartitionSpec, Rules, _map,
                                       logical_spec, make_rules, pspecs)
from repro_torch.quant.storage import QuantizedTensor

_CACHE_AXES = {
    "k": ("layers", "batch", "kvseq", "kvheads", None),
    "v": ("layers", "batch", "kvseq", "kvheads", None),
    "ck": ("layers", "batch", "kvseq", "kvheads", None),
    "cv": ("layers", "batch", "kvseq", "kvheads", None),
    "conv": ("layers", "batch", None, "ssm"),
    "ssd": ("layers", "batch", "ssm", None, None),
}


def state_pspecs(schema, rules: Rules):
    """Specs for {params, opt{m,v}, step} given the params schema."""
    p = pspecs(schema, rules)
    return {"params": p, "opt": {"m": p, "v": p},
            "step": PartitionSpec()}


def batch_pspecs(batch_tree, rules: Rules):
    def leaf(x):
        axes = ("batch",) + (None,) * (len(x.shape) - 1)
        return logical_spec(rules, *axes, dims=x.shape)
    return _map(leaf, batch_tree)


def cache_pspecs(cache_tree, rules: Rules):
    def walk(tree):
        out = {}
        for name, sub in tree.items():
            if isinstance(sub, dict):
                out[name] = walk(sub)
            else:
                axes = _CACHE_AXES[name]
                out[name] = logical_spec(rules, *axes, dims=sub.shape)
        return out
    return walk(cache_tree)


def placements(mesh, spec) -> tuple:
    """DTensor placements of one spec over ``mesh``."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} lists mesh axes {group} "
                             f"out of mesh order {tuple(names)}; DTensor "
                             f"would split it in another order")
        for i in idx:
            if mesh.size(i) > 1:     # a size-1 axis splits nothing
                out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` as its tuple of DTensor placements."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return placements(mesh, t)
    return walk(spec_tree)


def distribute_tree(tree, mesh, spec_tree):
    """Every tensor leaf of ``tree`` (and the ``data`` and ``scale`` of a
    QuantizedTensor) as a DTensor over ``mesh`` laid out by the matching
    spec of ``spec_tree``.  Every rank holds the same whole tree (drawn
    from one seed, read from one checkpoint, or meta tensors) and keeps
    its own slices: nothing moves between ranks."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, spec_tree[k])
                for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(
            tree, data=distribute_tree(tree.data, mesh, spec_tree.data),
            scale=distribute_tree(tree.scale, mesh, spec_tree.scale))
    return distribute_tensor(tree, mesh, list(placements(mesh, spec_tree)),
                             src_data_rank=None)


def rules_for(mesh, cfg: ModelConfig | None = None) -> Rules:
    return make_rules(mesh)
