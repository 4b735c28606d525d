"""Activation-sharding context.

Production sharded programs do not leave activation layouts to
propagation: every major activation gets an explicit anchor (the
MaxText/Megatron recipe).  Model code calls ``constrain(x,
*logical_axes)``; the launcher installs the logical->mesh rules for the
current mesh before the step runs.  Outside a launcher (unit tests,
single-device runs) the context is empty and ``constrain`` is the
identity, so model code never depends on a mesh; so it is for a plain
(non-DTensor) tensor.

Logical activation axes (resolved by ``repro_torch.models.schema.Rules``
with per-dim divisibility fallback to replication):

  batch    -> ("pod","data")   activation batch dim
  act_seq  -> "model"          sequence parallelism for the residual
                               stream (train/prefill; decode's seq=1
                               replicates by divisibility)
  qheads/kvheads/qgroups/mlp/ssm/experts/vocab -> "model" tensor
                               parallelism inside attention/FFN/SSD
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_RULES = [None]


def set_act_rules(rules) -> None:
    _RULES[0] = rules


def get_act_rules():
    return _RULES[0]


@contextlib.contextmanager
def act_rules(rules):
    prev = _RULES[0]
    _RULES[0] = rules
    try:
        yield
    finally:
        _RULES[0] = prev


def _layout(mesh, axes, dims) -> tuple:
    """DTensor placements of logical ``axes`` on a tensor of ``dims``
    under the installed rules."""
    from repro_torch.distributed.sharding import placements
    from repro_torch.models.schema import logical_spec
    return placements(mesh, logical_spec(_RULES[0], *axes, dims=dims))


def constrain(x, *axes):
    """Anchor activation ``x`` to its logical sharding: a DTensor is
    redistributed to the placements of ``logical_spec(rules, *axes,
    dims=x.shape)``; without rules, or for a plain tensor, ``x``."""
    if _RULES[0] is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          _layout(x.device_mesh, axes, x.shape))


def write_rows(dst, src, start: int, dim: int) -> None:
    """``dst.narrow(dim, start, n).copy_(src)`` in place, ``n =
    src.shape[dim]``.  For a DTensor ``dst`` each rank writes the rows
    that fall into its own shard: a slice of a sharded dim is not a view
    of the shard, so copying into it would write nothing."""
    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(src)
        return
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = dst.device_mesh
    along = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
             for p in dst.placements]
    if isinstance(src, DTensor):
        src = src.redistribute(mesh, along)
    else:
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False).redistribute(mesh, along)
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    lo = max(start, offset[dim])
    hi = min(start + n, offset[dim] + shape[dim])
    if lo < hi:
        dst.to_local().narrow(dim, lo - offset[dim], hi - lo).copy_(
            src.to_local().narrow(dim, lo - start, hi - lo))


def shard_local(fn, tensors, axes, out_like=(0,), partial_of=None):
    """``fn(*tensors)`` for a function that works on each rank's shards
    alone.  On DTensors under installed rules it runs on the local
    shards (``local_map``): tensor ``i`` is laid out by its logical
    ``axes[i]``, and result ``j`` takes the layout of tensor
    ``out_like[j]`` (one result when ``out_like`` has one entry).  An
    entry ``(i, dims)`` gives a result whose dim ``k`` is split as dim
    ``dims[k]`` of tensor ``i`` (``None``: a dim no input carries; a
    split dim of tensor ``i`` must appear in ``dims``).  With
    ``partial_of = (i, d)``, the mesh axes that split dim ``d`` of
    tensor ``i`` hold partial sums of the results (a contraction over a
    split dim).  A plain tensor among ``tensors`` is taken as
    replicated.  The gradient of a tensor that is whole on a mesh axis
    where another is split (a weight beside a rank's rows) is a partial
    sum over that axis: every result is taken to depend on the split
    work."""
    rules = _RULES[0]
    dt = next((t for t in tensors if isinstance(t, DTensor)), None)
    if rules is None or dt is None:
        return fn(*tensors)
    from torch.distributed.tensor.experimental import local_map
    mesh = dt.device_mesh
    tensors = [t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for t in tensors]
    ins = tuple(_layout(mesh, a, t.shape) for a, t in zip(axes, tensors))
    outs = [list(ins[o]) if isinstance(o, int) else _moved(ins[o[0]], o[1])
            for o in out_like]
    if partial_of is not None:
        i, d = partial_of
        for m, pl in enumerate(ins[i]):
            if isinstance(pl, Shard) and pl.dim == d:
                for o in outs:
                    o[m] = Partial()
    split = [any(isinstance(pl[m], Shard) for pl in ins)
             for m in range(mesh.ndim)]
    grads = tuple(tuple(Partial() if split[m] and isinstance(q, Replicate)
                        else q for m, q in enumerate(pl)) for pl in ins)
    return local_map(functools.partial(_row_major, fn),
                     out_placements=tuple(tuple(o) for o in outs),
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*tensors)


def _moved(pl, dims) -> list:
    """Placements ``pl`` of an input, for a result whose dim ``k`` is the
    input's dim ``dims[k]``."""
    return [Shard(dims.index(p.dim)) if isinstance(p, Shard) else p
            for p in pl]


class _RowMajorGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient row-major."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _row_major(fn, *tensors):
    """``fn`` on local shards, its results and its arguments' gradients
    made row-major: ``local_map`` wraps each as a DTensor whose global
    strides are the row-major ones, and a later view of a shard laid out
    otherwise (an einsum's permuted output) would fail."""
    out = fn(*(_RowMajorGrad.apply(t) if t.requires_grad else t
               for t in tensors))
    if isinstance(out, tuple):
        return tuple(o.contiguous() for o in out)
    return out.contiguous()


def batch_local(fn, *tensors, n_out: int = 1):
    """``fn(*tensors)`` for a function that works on each batch row
    alone (dim 0 of every argument and of each of its ``n_out``
    results): on a mesh, on each rank's rows, every other dim
    replicated."""
    return shard_local(fn, tensors, [("batch",) + (None,) * (t.ndim - 1)
                                     for t in tensors], (0,) * n_out)


def _groups(old, new) -> list[tuple[list, list]]:
    """Pair the dims of a reshape: (old dims, new dims) groups of equal
    element count, in order (size-1 dims join the group before them)."""
    groups, i, j = [], 0, 0
    while i < len(old) or j < len(new):
        oi, nj = [], []
        po = pn = 1
        while True:
            if i < len(old) and (po <= pn or j == len(new)):
                oi.append(i)
                po *= old[i]
                i += 1
            elif j < len(new):
                nj.append(j)
                pn *= new[j]
                j += 1
            if po == pn and oi and nj and (
                    i == len(old) or old[i] != 1) and (
                    j == len(new) or new[j] != 1):
                break
            if i == len(old) and j == len(new):
                break
        groups.append((oi, nj))
    return groups


def reshape(x, shape, *axes):
    """``x.reshape(shape)`` anchored to the logical ``axes`` of the
    result (``constrain``).  On a DTensor under rules, ``x`` is first
    laid out so that the reshape moves nothing: in each group of merged
    or split dims only the leading old dim is sharded, on the axes that
    the result gives its leading new dim when they divide it.  A view of
    a DTensor never redistributes: it raises, or (in newer torch) keeps
    strided shards that later ops pay for."""
    rules = _RULES[0]
    if rules is None or not isinstance(x, DTensor):
        return x.reshape(shape)
    from repro_torch.distributed.sharding import placements
    from repro_torch.models.schema import PartitionSpec, logical_spec
    shape = tuple(shape)
    spec = logical_spec(rules, *axes, dims=shape)
    pre = [None] * x.ndim
    for old, new in _groups(tuple(x.shape), shape):
        if not old or not new or spec[new[0]] is None:
            continue
        entry = spec[new[0]]
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        n = math.prod(rules.sizes[a] for a in group)
        if x.shape[old[0]] % n == 0 and shape[new[0]] % n == 0:
            pre[old[0]] = entry
    mesh = x.device_mesh
    x = x.redistribute(mesh, placements(mesh, PartitionSpec(*pre)))
    return constrain(x.reshape(shape), *axes)


class _GradAsParam(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the input."""

    @staticmethod
    def forward(ctx, t):
        ctx.layout = (t.device_mesh, t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout) if isinstance(g, DTensor) else g


def grad_as_param(t):
    """``t``, whose gradient arrives laid out as ``t`` itself on a mesh:
    for a parameter used twice (a tied embedding), so that the two
    gradients add in one layout (DTensor cannot turn a shard into a
    partial sum)."""
    return _GradAsParam.apply(t) if isinstance(t, DTensor) else t
