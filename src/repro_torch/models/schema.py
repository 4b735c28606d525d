"""Parameter schemas: one source of truth for shapes and init.

A model describes its parameters as a nested dict of :class:`P` leaves
(shape + logical axes + init rule); ``init_params`` materializes it,
``abstract_params`` gives its shapes and dtypes as meta tensors (the
checkpoint reader's template; nothing is allocated) and ``param_count``
counts it.  The logical axes are kept from the reference
for its sharding rules, which the port does not use yet.
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
