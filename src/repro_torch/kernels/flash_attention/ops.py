"""Blockwise attention as PyTorch operators: ``repro_torch::flash_fwd``
and ``repro_torch::flash_bwd``.

The CUDA implementations launch ``csrc/flash_attention.cu`` on the
current stream; the CPU implementations are the plain versions; the
fake implementations give meta and fake tensors their shapes (the dry
run traces a step on them).  The forward's autograd saves q, k, v, o and
lse and calls ``flash_bwd``.  Each op has a FLOP formula for
``torch.utils.flop_counter``: what the reference's scan computes, every
block pair, ``4 B Sq Sk Hq D`` forward and twice that backward.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .kernel import flash_bwd_cuda, flash_fwd_cuda


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, q_block: int, kv_block: int,
              q_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B,Sq,Hkv,G,D], k/v [B,Sk,Hkv,D] -> (o in q's type, lse
    [B,Sq,Hkv,G] float32)."""
    return flash_fwd_cuda(q, k, v, causal=causal, q_block=q_block,
                          kv_block=kv_block, q_offset=q_offset)


@flash_fwd.register_kernel("cuda")
def _(q, k, v, causal, q_block, kv_block, q_offset):
    return flash_fwd_cuda(q, k, v, causal=causal, q_block=q_block,
                          kv_block=kv_block, q_offset=q_offset)


@flash_fwd.register_fake
def _(q, k, v, causal, q_block, kv_block, q_offset):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:4], dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=(),
                         device_types="cpu")
def flash_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
              causal: bool, q_block: int, kv_block: int,
              q_offset: int) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """-> (dq, dk, dv) in the inputs' types."""
    return flash_bwd_cuda(do, q, k, v, o, lse, causal=causal,
                          q_block=q_block, kv_block=kv_block,
                          q_offset=q_offset)


@flash_bwd.register_kernel("cuda")
def _(do, q, k, v, o, lse, causal, q_block, kv_block, q_offset):
    return flash_bwd_cuda(do, q, k, v, o, lse, causal=causal,
                          q_block=q_block, kv_block=kv_block,
                          q_offset=q_offset)


@flash_bwd.register_fake
def _(do, q, k, v, o, lse, causal, q_block, kv_block, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, q_block, kv_block, q_offset = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.args = (causal, q_block, kv_block, q_offset)
    ctx.mark_non_differentiable(lse)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(do, q, k, v, o, lse, *ctx.args)
    return dq, dk, dv, None, None, None, None


flash_fwd.register_autograd(_backward, setup_context=_setup_context)


def _attn_flops(q_shape, k_shape) -> int:
    B, Sq, Hkv, G, D = q_shape
    return 4 * B * Sq * k_shape[1] * Hkv * G * D


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _fwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return _attn_flops(q_shape, k_shape)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _bwd_flops(do_shape, q_shape, k_shape, *args, out_shape=None,
               **kwargs) -> int:
    return 2 * _attn_flops(q_shape, k_shape)


def flash_attention(q, k, v, *, causal: bool, q_block: int, kv_block: int,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,Hkv,G,D], k/v [B,Sk,Hkv,D] -> o [B,Sq,Hkv,G,D] in q's
    type, differentiable in q, k and v."""
    return flash_fwd(q, k, v, causal, q_block, kv_block, q_offset)[0]
