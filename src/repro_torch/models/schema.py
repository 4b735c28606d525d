"""Parameter schemas: one source of truth for shapes and init.

A model describes its parameters as a nested dict of :class:`P` leaves
(shape + logical axes + init rule); ``init_params`` materializes it,
``abstract_params`` gives its shapes and dtypes as meta tensors (the
checkpoint reader's template; nothing is allocated) and ``param_count``
counts it, and ``pspecs`` derives its :class:`PartitionSpec` tree from
logical-axis rules with divisibility-aware fallback to replication.

Logical axes used by the model stack:

  embed   d_model-sized dims         -> FSDP over the data(+pod) axes
  vocab   (padded) vocabulary        -> "model"
  qheads  fused n_heads*d_head       -> "model"
  kvheads fused n_kv*d_head          -> "model" (replicated when too few)
  mlp     d_ff                       -> "model"
  experts MoE expert count           -> "model" (EP) when divisible
  ssm     SSD inner features/heads   -> "model"
  layers  stacked leading dim        -> never sharded

The rules are pure Python: they read only the mesh's axis names and
sizes.  ``repro_torch.distributed.sharding.named`` turns a spec into
DTensor placements.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class P:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]          # logical name / None per dim
    init: str = "normal"           # normal | zeros | ones
    scale: float | None = None     # stddev for normal (default fan-in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _map(fn, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Tree) -> list:
    """Leaves in sorted-key order (the order ``jax.tree`` flattens a
    dict in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(tree: Tree, leaves) -> Tree:
    """``tree`` with its leaves, in sorted-key order, replaced by
    ``leaves``."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)

    return walk(tree)


def stack(schema: Tree, n: int) -> Tree:
    """Prepend an unsharded leading 'layers' dim of size n to every leaf."""
    return _map(lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init,
                            p.scale), schema)


def _leaf_init(p: P, generator: torch.Generator, dtype, device):
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init != "normal":
        raise ValueError(p.init)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    std = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w.mul_(std)).to(device=device, dtype=dtype)


def init_params(schema: Tree, generator: torch.Generator, device,
                dtype=torch.float32) -> Tree:
    """Materialize ``schema`` on ``device``: normal leaves draw from
    ``generator`` (on the generator's device), leaf by leaf in
    sorted-key order."""
    if isinstance(schema, dict):
        return {k: init_params(schema[k], generator, device, dtype)
                for k in sorted(schema)}
    return _leaf_init(schema, generator, dtype, device)


def abstract_params(schema: Tree, dtype=torch.float32) -> Tree:
    """``schema`` as meta-device tensors of its shapes and ``dtype``."""
    return _map(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"),
                schema)


def param_count(schema: Tree) -> int:
    return sum(math.prod(p.shape) for p in _leaves(schema))


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of mesh axis names (major to minor).  A tuple, so
    that it compares equal to the same entries written as one."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis -> mesh axis (str, tuple, or candidate list).
    ``sizes`` maps mesh axis name -> size for divisibility checks.
    A list value holds fallback candidates tried in order (first whose
    axes are unused and divide the dim wins)."""
    table: dict
    sizes: dict

    def resolve(self, logical, dim: int, used=frozenset()):
        cands = self.table.get(logical)
        if cands is None:
            return None
        if not isinstance(cands, list):
            cands = [cands]
        for mesh_axes in cands:
            group = ((mesh_axes,) if isinstance(mesh_axes, str)
                     else tuple(mesh_axes))
            if set(group) & set(used):
                continue
            total = math.prod(self.sizes[a] for a in group)
            if dim % total == 0:
                # normalize 1-tuples to the bare axis name so specs
                # compare equal regardless of how the rule was written
                if (not isinstance(mesh_axes, str)
                        and len(tuple(mesh_axes)) == 1):
                    return tuple(mesh_axes)[0]
                return mesh_axes
        return None  # replicate rather than emit invalid sharding


def pspecs(schema: Tree, rules: Rules) -> Tree:
    def leaf(p: P):
        spec = []
        used = set()
        for dim, ax in zip(p.shape, p.axes):
            r = rules.resolve(ax, dim, used)
            flat = ((r,) if isinstance(r, str) else tuple(r or ()))
            if r is not None:
                used |= set(flat)
            spec.append(r)
        return PartitionSpec(*spec)
    return _map(leaf, schema)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``,
    ``shape``) or of any object with ``axis_names`` and
    ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def make_rules(mesh, *, fsdp: bool = True, seq_parallel: bool = True) -> Rules:
    """Standard rule set for the production meshes (see DESIGN.md §4)."""
    sizes = mesh_axes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    data = data_axes if len(data_axes) > 1 else data_axes[0]
    table = {
        "embed": data if fsdp else None,
        "vocab": "model",
        "qheads": "model",
        "kvheads": "model",
        "qgroups": "model",
        "act_seq": "model" if seq_parallel else None,
        "mlp": "model",
        "experts": "model",
        "emlp": "model",
        "ssm": "model",
        "batch": data,
        # KV cache sequence axis: long-context decode (batch=1) takes the
        # widest split; otherwise the leftover "model" axis (batch owns
        # the data axes).
        "kvseq": [tuple(data_axes) + ("model",), ("model",)],
        "layers": None,
    }
    return Rules(table, sizes)


def logical_spec(rules: Rules, *axes, dims=None) -> PartitionSpec:
    """PartitionSpec for an activation with the given logical axes.
    ``dims`` (same length) enables divisibility checks when known."""
    spec = []
    used = set()
    for i, ax in enumerate(axes):
        if ax is None:
            spec.append(None)
            continue
        d = None if dims is None else dims[i]
        if d is not None:
            r = rules.resolve(ax, d, used)
        else:
            r = rules.table.get(ax)
            if isinstance(r, list):
                r = r[0]
            flat = ((r,) if isinstance(r, str) else tuple(r or ()))
            if set(flat) & used:
                r = None
        flat = ((r,) if isinstance(r, str) else tuple(r or ()))
        if r is not None:
            used |= set(flat)
        spec.append(r)
    return PartitionSpec(*spec)
