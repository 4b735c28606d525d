"""Plain torch versions of the blockwise attention kernels: the
reference's two nested scans (``repro.models.attention._flash``) as
Python loops over blocks, on tensors of any device.

``split_bf16`` is the kernels' split of a float32 operand into three
bf16 values for the tensor cores.

Layouts: q [B, Sq, Hkv, G, D] (G query heads a kv head), k and v
[B, Sk, Hkv, D]; o in q's type, lse [B, Sq, Hkv, G] float32.  Where Sq
or Sk is not a multiple of its block, the last block is short (the
reference asserts there).  Matmuls here are float32: leave TF32 off
(``torch.backends.cuda.matmul.allow_tf32``, False by default) when
running them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _blocks(n: int, block: int):
    t = min(block, n)
    return [(s, min(s + t, n)) for s in range(0, n, t)]


def _bias(q0, q1, k0, k1, q_offset, device):
    """[q1 - q0, k1 - k0] additive causal bias from block bounds + arange."""
    qp = torch.arange(q0, q1, device=device) + q_offset
    kp = torch.arange(k0, k1, device=device)
    return torch.where(qp[:, None] >= kp[None, :], 0.0,
                       NEG_INF).to(torch.float32)


def flash_fwd_ref(q, k, v, *, causal: bool, q_block: int, kv_block: int,
                  q_offset: int = 0):
    """-> (o [B,Sq,Hkv,G,D] in q's type, lse [B,Sq,Hkv,G] float32).

    Running (max, denominator, accumulator) in float32 over kv blocks,
    q pre-scaled by D^-0.5, the causal mask an additive -1e30; ``lse =
    m + log(l)`` is what the backward recomputes probabilities from."""
    B, Sq, Hkv, G, D = q.shape
    Sk = k.shape[1]
    qf = q.to(torch.float32) * D ** -0.5
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Sq, Hkv, G), dtype=torch.float32, device=q.device)
    for q0, q1 in _blocks(Sq, q_block):
        qc = qf[:, q0:q1]
        m = torch.full((B, q1 - q0, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, dtype=torch.float32, device=q.device)
        for k0, k1 in _blocks(Sk, kv_block):
            s = torch.einsum("btkgd,bukd->btkgu", qc, kf[:, k0:k1])
            if causal:
                s = s + _bias(q0, q1, k0, k1, q_offset,
                              q.device)[None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "btkgu,bukd->btkgd", p, vf[:, k0:k1])
            m = m_new
        o[:, q0:q1] = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        lse[:, q0:q1] = m + torch.log(l)
    return o, lse


def flash_bwd_ref(do, q, k, v, o, lse, *, causal: bool, q_block: int,
                  kv_block: int, q_offset: int = 0):
    """-> (dq, dk, dv) in the inputs' types: the standard recompute
    backward, each block's probabilities ``exp(s - lse)``; dk and dv
    summed over the G query heads of their kv head."""
    B, Sq, Hkv, G, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    qf = q.to(torch.float32) * scale
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dof = do.to(torch.float32)
    dvec = (dof * o.to(torch.float32)).sum(-1)          # [B,Sq,Hkv,G]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for q0, q1 in _blocks(Sq, q_block):
        qc, doc = qf[:, q0:q1], dof[:, q0:q1]
        lc, dc = lse[:, q0:q1, ..., None], dvec[:, q0:q1, ..., None]
        for k0, k1 in _blocks(Sk, kv_block):
            kc, vc = kf[:, k0:k1], vf[:, k0:k1]
            s = torch.einsum("btkgd,bukd->btkgu", qc, kc)
            if causal:
                s = s + _bias(q0, q1, k0, k1, q_offset,
                              q.device)[None, :, None, None, :]
            p = torch.exp(s - lc)
            dv[:, k0:k1] += torch.einsum("btkgu,btkgd->bukd", p, doc)
            ds = p * (torch.einsum("btkgd,bukd->btkgu", doc, vc) - dc)
            dq[:, q0:q1] += torch.einsum("btkgu,bukd->btkgd", ds, kc)
            dk[:, k0:k1] += torch.einsum("btkgu,btkgd->bukd", ds, qc)
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def split_bf16(x):
    """The bf16 route's split of a float32 tensor: ``(hi, mid, lo)`` in
    bfloat16 with ``hi + mid + lo == x`` exactly (``hi = bf16(x)``,
    ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``, each rounded to
    nearest even and each subtraction exact in float32).  ``lo`` holds
    the last 8 or fewer significant bits of x, so the sum is exact unless
    x is below ~2^-100, where they fall among bf16's subnormals, or
    |x| >= 2^128 (1 - 2^-9), where hi rounds to infinity.  The
    kernels (``csrc/flash_attention.cu``, ``split3``) compute P.v as
    hi.v + mid.v + lo.v with bf16 v: three exact bf16 products."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo
