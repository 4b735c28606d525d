"""AdamW with global-norm clipping and a warmup-cosine schedule.

Moments live in ``moment_dtype`` (bf16 moments halve their footprint).
The arithmetic is the reference's, in float32 tensors: the schedule, the
bias corrections ``1 - beta ** t`` with ``t`` in float32, and every
update; Python floats enter only as the scalar operands the reference
gives as weakly typed constants.  Leaves are visited in sorted-key
order, the order in which ``jax.tree`` flattens a dict.

``adamw_update`` writes the new parameters and moments IN PLACE, under
``torch.no_grad``: the counterpart of the reference's donated train
state, so the state is never held twice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.models.schema import _leaves, _map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(opt: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a 0-d
    float32 tensor on ``step``'s device."""
    step = _f32(step)
    warm = torch.clamp((step + 1.0) / max(opt.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = opt.min_lr_ratio + (1.0 - opt.min_lr_ratio) * cos
    return opt.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in sorted-key order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in _leaves(tree)))


def adamw_init(params, opt: OptConfig):
    dt = dtype_of(opt.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": _map(zeros, params), "v": _map(zeros, params)}


@torch.no_grad()
def adamw_update(params, grads, opt_state, step, opt: OptConfig):
    """One AdamW step, in place.  ``grads`` is a tree like ``params``;
    ``step`` the 0-based step (int or 0-d tensor).  Returns (params,
    opt_state, metrics), the first two the trees passed in, metrics
    ``{"grad_norm", "lr"}`` 0-d float32 tensors."""
    flat_p = _leaves(params)
    flat_g = _leaves(grads)
    flat_m = _leaves(opt_state["m"])
    flat_v = _leaves(opt_state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"{len(flat_p)} parameters, {len(flat_g)} "
                         f"gradients, {len(flat_m)}/{len(flat_v)} moments")
    dev = flat_p[0].device
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(opt.clip, dev) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = torch.as_tensor(step, device=dev)
    lr = lr_at(opt, step)
    t = _f32(step) + 1.0
    bc1 = 1.0 - opt.beta1 ** t
    bc2 = 1.0 - opt.beta2 ** t
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.to(torch.float32) * scale
        m32 = opt.beta1 * m.to(torch.float32) + (1 - opt.beta1) * g
        v32 = opt.beta2 * v.to(torch.float32) + (1 - opt.beta2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        step_ = mhat / (torch.sqrt(vhat) + opt.eps)
        p32 = p.to(torch.float32)
        p.copy_(p32 - lr * (step_ + opt.weight_decay * p32))
        m.copy_(m32)
        v.copy_(v32)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
