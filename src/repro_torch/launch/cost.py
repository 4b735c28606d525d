"""Per-device cost of a step, counted from the ops it dispatches.

The reference compiles a step and walks XLA's HLO text
(``repro.launch.hlo_cost``): its while loops hide trip counts, so that
module re-multiplies each loop body.  The port has no HLO: a step is
eager PyTorch, so its cost is counted op by op as the step dispatches
them, inside a ``TorchDispatchMode`` (``CostMode``).  Nothing needs a
trip count: ``apply_stack`` loops over layers and micro-batches in
Python, so every layer's ops, remat's recomputed forward among them,
pass through the mode.  That is why ``hlo_cost``'s HLO parser has no
counterpart here.

The dry run runs the step on meta tensors wrapped in DTensors over a
(fake) process group.  The mode returns ``NotImplemented`` for tensor
subclasses (DTensor, the collectives' async wrapper), so they lower
themselves to ops on local shards first: every figure is per device.
DTensor derives each op's global output shape by running it once more
on global tensors under a fake-tensor mode of its own; those runs are
not device work, and ``no_shadow_ops`` (which the mode enters) hides
them from every dispatch mode, ``MemTracker`` among them.

Per local op:

  flops      — matmul and convolution FLOPs by the formulas of
               ``torch.utils.flop_counter.FlopCounterMode`` (its
               ``flop_registry``); ``flops_by_dtype`` splits them by
               the type they run in, ``tf32`` for float32 operands while
               TF32 is allowed (``torch.backends``' flags at dispatch),
               since each type runs at its own peak; the bf16 blockwise
               attention's entry counts the half-products its kernels
               need (``FLASH_HALF_PRODUCTS``), more than its formula
  elem_flops — elementwise and reduction work, kept apart as
               ``hlo_cost`` folds it into its flops: the output elements
               of a pointwise op, the input elements of a reduction,
               n log2 n for a sort
  bytes      — operand + output bytes of every op that moves data
               (views, metadata and allocation ops move none): unfused,
               so an upper bound on what fused kernels move
  coll_bytes — operand bytes of every ``_c10d_functional`` /
               ``c10d_functional`` collective (``coll_hist`` by kind,
               ``coll_by_group`` by process-group name), i.e. what each
               device puts on its links
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_COLL_NS = ("_c10d_functional", "c10d_functional")
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
         "set_", "resize_"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp", "prod",
           "var", "std", "var_mean", "norm", "linalg_vector_norm", "any",
           "all", "argmax", "argmin", "cumsum", "cumprod", "_softmax",
           "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data"}
_SORT = {"sort", "topk", "argsort"}


@contextlib.contextmanager
def no_shadow_ops():
    """Hide from every dispatch mode the ops that DTensor runs once more
    on global shapes, under a fake-tensor mode of its own, to derive an
    op's output metadata: they are not device work, and a global-shape
    tensor would enter a memory peak (torch 2.11's MemTracker counts
    them: a 64-layer grok-1-314b train cell read 1152 GiB a device).
    It patches DTensor's private ``ShardingPropagator``;
    ``tests/test_torch_dist.py`` fails if the shadow ops come back."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def hidden(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = hidden
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


# The blockwise attention ops on bf16 inputs run on the tensor cores,
# each float32 product of the FLOP formula split exactly into bf16
# half-products.  A score element takes FLASH_HALF_PRODUCTS of them:
# forward 4 for the formula's 2 products, backward 11 for its 4 (the
# kernels recompute the scores, a fifth product).
FLASH_HALF_PRODUCTS = {"fwd": 4, "bwd": 11}
_FLASH_FORMULA_PRODUCTS = {"fwd": 2, "bwd": 4}


def _flop_kind(name: str, dtype) -> tuple[str, float]:
    """The type a matmul or convolution runs in, and its FLOPs in that
    type as a multiple of the formula's.  The type is the operands'
    dtype, or ``tf32`` for float32 operands while TF32 is allowed for
    it.  The blockwise attention ops (``flash_fwd``/``flash_bwd``) run
    bf16 inputs on the tensor cores, over ``FLASH_HALF_PRODUCTS``, and
    float32 ones in float32 FMAs, TF32 or not."""
    if name in ("flash_fwd", "flash_bwd"):
        if dtype != torch.bfloat16:
            return "float32", 1.0
        which = name.removeprefix("flash_")
        return "bfloat16", (FLASH_HALF_PRODUCTS[which]
                            / _FLASH_FORMULA_PRODUCTS[which])
    if dtype == torch.float32:
        conv = "convolution" in name
        if (torch.backends.cudnn.allow_tf32 if conv
                else torch.backends.cuda.matmul.allow_tf32):
            return "tf32", 1.0
    return str(dtype).removeprefix("torch."), 1.0


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    elem_flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_hist: dict = dataclasses.field(default_factory=dict)
    coll_by_group: dict = dataclasses.field(default_factory=dict)
    ops: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class CostMode(TorchDispatchMode):
    """Counts :class:`Cost` of the local ops dispatched in its context
    (``self.cost``)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._hidden = None

    def __enter__(self):
        self._hidden = no_shadow_ops()
        self._hidden.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hidden.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and t is not FakeTensor
               and issubclass(t, torch.Tensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns == "prim" or name in _FREE or func.is_view:
            return
        c = self.cost
        c.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        moved = _nbytes(ins) + _nbytes(outs)
        if ns in _COLL_NS:
            opd = _nbytes(ins)
            c.coll_bytes += opd
            c.coll_hist[name] = c.coll_hist.get(name, 0) + opd
            group = kwargs.get("group_name") or [
                a for a in args if isinstance(a, str)][-1]
            c.coll_by_group[group] = c.coll_by_group.get(group, 0) + opd
            c.bytes += moved
            return
        c.bytes += moved
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            kind, times = _flop_kind(name, ins[0].dtype)
            c.flops_by_dtype[kind] = (c.flops_by_dtype.get(kind, 0)
                                      + f * times)
        elif torch.Tag.pointwise in func.tags:
            c.elem_flops += sum(t.numel() for t in outs)
        elif name in _REDUCE:
            c.elem_flops += ins[0].numel() if ins else 0
        elif name in _SORT and ins:
            n = ins[0].numel()
            c.elem_flops += n * max(math.log2(max(n, 2)), 1.0)
