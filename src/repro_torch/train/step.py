"""The train step: remat'd model, micro-batch gradient accumulation,
AdamW, metrics.

A step with ``n_micro > 1`` splits the batch into micro-batches, takes
each one's gradients with ``torch.autograd.grad`` and adds them into a
buffer of ``grad_dtype`` (the reference's ``lax.scan`` accumulation):
the activation working set shrinks by the accumulation factor.  The
optimizer then updates the parameters and moments in place, so the
train state is never held twice (the reference donates it).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.distributed.ctx import batch_local

from repro_torch.models import lm_loss, model_schema
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.schema import (_leaves, _map, _unflatten,
                                       abstract_params, init_params)
from repro_torch.optim import OptConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    n_micro: int = 1            # gradient-accumulation factor
    aux_weight: float = 0.01    # MoE load-balance loss weight
    grad_dtype: str = "float32"  # accumulation buffer; bf16 halves it


def init_state(cfg: ModelConfig, tc: TrainConfig,
               generator: torch.Generator, device):
    """Parameters drawn by ``init_params`` from ``generator`` onto
    ``device``, zero moments, step 0 (a 0-d int32 tensor)."""
    params = init_params(model_schema(cfg), generator, device)
    return {"params": params, "opt": adamw_init(params, tc.opt),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(cfg: ModelConfig, tc: TrainConfig):
    """The train state's shapes and dtypes as meta tensors."""
    params = abstract_params(model_schema(cfg))
    mdt = dtype_of(tc.opt.moment_dtype)
    moments = _map(lambda p: torch.empty(p.shape, dtype=mdt, device="meta"),
                   params)
    return {"params": params, "opt": {"m": moments, "v": moments},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _micro(v, *, n: int, i: int):
    """Micro-batch ``i`` of ``n``: rows ``i * B/n`` to ``(i + 1) * B/n``
    (on a mesh, of each rank's own rows)."""
    return v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]


def mesh_rows(batch, n: int, rules):
    """``batch`` with its rows ordered for a mesh run of ``n``
    micro-batches under ``rules``: the ranks hold equal blocks of rows
    and :func:`_micro` takes block ``i`` of each rank's rows, so that
    micro-batch ``i`` is, over the ranks, the one-device step's rows
    ``i * B/n`` to ``(i + 1) * B/n``.  The whole batch's loss does not
    depend on the order; a micro-batch's (its MoE aux) does."""
    from repro_torch.models.schema import logical_spec

    def order(v):
        entry = logical_spec(rules, "batch", dims=v.shape[:1])[0]
        group = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        r = 1
        for a in group:
            r *= rules.sizes[a]
        lead = (n, r, v.shape[0] // (n * r))
        return v.reshape(lead + v.shape[1:]).transpose(0, 1).reshape(
            v.shape)
    return {k: order(v) for k, v in batch.items()}


def train_state_specs(cfg: ModelConfig, rules):
    from repro_torch.distributed.sharding import state_pspecs
    return state_pspecs(model_schema(cfg), rules)


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics): the state
    updated in place and returned, metrics 0-d float32 tensors
    ``{"xent", "aux", "loss", "grad_norm", "lr"}`` as the reference's
    (with ``n_micro > 1``: ``xent`` and ``loss`` the micro-batches' mean
    total loss, ``aux`` 0)."""

    def grad_fn(params, mb):
        """(total loss, metrics, gradients of the leaves in sorted-key
        order), all detached."""
        live = [p.detach().requires_grad_() for p in _leaves(params)]
        loss, metrics = lm_loss(_unflatten(params, live), mb, cfg,
                                aux_weight=tc.aux_weight)
        grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(state, batch):
        params = state["params"]
        if tc.n_micro == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            n = tc.n_micro
            gdt = dtype_of(tc.grad_dtype)
            grads = [torch.zeros_like(p, dtype=gdt) for p in _leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
            for i in range(n):
                mb = {k: batch_local(functools.partial(_micro, n=n, i=i), v)
                      for k, v in batch.items()}
                l, _, g = grad_fn(params, mb)
                for a, b in zip(grads, g):
                    a.add_(b.to(gdt))
                del g
                loss = loss + l
            inv = 1.0 / n
            grads = [g.mul_(inv) for g in grads]
            loss = loss * inv
            metrics = {"xent": loss, "aux": torch.zeros_like(loss)}
        _, _, opt_metrics = adamw_update(params, _unflatten(params, grads),
                                         state["opt"], state["step"], tc.opt)
        state["step"].add_(1)
        return state, dict(metrics, loss=loss, **opt_metrics)

    return train_step
