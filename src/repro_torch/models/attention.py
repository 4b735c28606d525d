"""GQA/MQA attention: blockwise (flash) attention over a whole sequence
(train and prefill), and cached decode of one token.

Training and prefill never materialize the [S, S] score matrix: as in
the reference's ``_flash``, query blocks attend to kv blocks with a
running (max, denominator, accumulator) triple in float32, and the
backward recomputes each block's probabilities from the saved
log-sum-exp.  On the card that is one CUDA kernel for the forward and
four for the backward (``kernels.flash_attention``); on the CPU their
plain versions.  Decode attends one query against a pre-allocated KV
cache with a length mask plus an explicit self term.
"""
from __future__ import annotations

import functools

import torch

from repro_torch._build import resolve_device
from repro_torch.distributed.ctx import constrain, reshape, shard_local
from repro_torch.kernels.flash_attention.ops import flash_attention

from .config import ModelConfig
from .layers import apply_rope, rmsnorm, rope_angles, weight_getter
from .schema import P

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------
def attn_schema(cfg: ModelConfig):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {"wq": P((d, hq * dh), ("embed", "qheads")),
         "wk": P((d, hkv * dh), ("embed", "kvheads")),
         "wv": P((d, hkv * dh), ("embed", "kvheads")),
         "wo": P((hq * dh, d), ("qheads", "embed"))}
    if cfg.qkv_bias:
        s["bq"] = P((hq * dh,), ("qheads",), "zeros")
        s["bk"] = P((hkv * dh,), ("kvheads",), "zeros")
        s["bv"] = P((hkv * dh,), ("kvheads",), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = P((dh,), (None,), "ones")
        s["k_norm"] = P((dh,), (None,), "ones")
    return s


def _project_qkv(p, x, cfg: ModelConfig, positions, deq=None):
    """x [B,T,d] -> q [B,T,Hq,D], k/v [B,T,Hkv,D] (roped, normed)."""
    get = weight_getter(p, deq)
    B, T, _ = x.shape
    dh = cfg.head_dim
    q = x @ get("wq").to(x.dtype)
    k = x @ get("wk").to(x.dtype)
    v = x @ get("wv").to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = reshape(q, (B, T, cfg.n_heads, dh), "batch", None, "qheads", None)
    k = reshape(k, (B, T, cfg.n_kv_heads, dh),
                "batch", None, "kvheads", None)
    v = reshape(v, (B, T, cfg.n_kv_heads, dh),
                "batch", None, "kvheads", None)
    if cfg.qk_norm:
        q = rmsnorm({"scale": p["q_norm"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": p["k_norm"]}, k, cfg.norm_eps)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


# ---------------------------------------------------------------------------
# Flash-style blockwise attention (train / prefill)
# ---------------------------------------------------------------------------
def _flash(q, k, v, *, causal: bool, q_block: int, kv_block: int,
           q_offset: int = 0):
    """q [B,S,Hq,D], k/v [B,S,Hkv,D] -> [B,S,Hq,D].  Blockwise softmax.

    Query groups are laid out as the reference anchors its blocks
    (kv-heads, or when too few the groups within one, over model); each
    rank then runs ``repro_torch::flash_fwd`` on its own rows and heads.
    ``q_block``/``kv_block`` fix the plain version's order of summation;
    the CUDA kernels tile on their own, and any S runs (a last block may
    be short)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    q5 = ("batch", None, "kvheads", "qgroups", None)
    kv = ("batch", None, "kvheads", None)
    o = shard_local(functools.partial(flash_attention, causal=causal,
                                      q_block=q_block, kv_block=kv_block,
                                      q_offset=q_offset),
                    (reshape(q, (B, Sq, Hkv, Hq // Hkv, D), *q5), k, v),
                    (q5, kv, kv))
    return reshape(o, (B, Sq, Hq, D), "batch", None, "qheads", None)


def attention(p, x, cfg: ModelConfig, *, causal: bool = True,
              q_block: int = 512, kv_block: int = 512, deq=None):
    """Full attention over x (train/prefill).  Returns (out, (k, v))."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _project_qkv(p, x, cfg, positions, deq)
    o = _flash(q, k, v, causal=causal, q_block=q_block, kv_block=kv_block)
    o = reshape(o, (B, T, cfg.n_heads * cfg.head_dim), "batch", None,
                "qheads")
    out = o @ weight_getter(p, deq)("wo").to(x.dtype)
    return out, (k, v)


# ---------------------------------------------------------------------------
# Cached decode
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, device="cuda"):
    device = resolve_device(device)
    dh, hkv = cfg.head_dim, cfg.n_kv_heads
    shape = (n_layers, batch, max_len, hkv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, x, cfg: ModelConfig, layer_cache, pos: int,
                     deq=None):
    """One-token decode over a READ-ONLY cache.

    x [B,1,d]; layer_cache {k,v}: [B,Smax,Hkv,D] holding tokens
    0..pos-1; the current token attends to the cache plus an explicit
    self term, and the fresh (k_new, v_new) are returned for the caller
    to write at ``pos``.
    Returns (out [B,1,d], {"k_new","v_new"} [B,1,Hkv,D])."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, deq)

    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = Hq // Hkv
    # On a mesh the cache is split over its sequence, so the token's
    # heads stay whole and the scores keep the cache's sequence
    # sharding.  (The reference anchors the scores with kv-heads first;
    # DTensor cannot then take the views that the next einsum makes.)
    qf = reshape(q, (B, Hkv, G, D), "batch", None, None,
                 None).to(torch.float32) * D ** -0.5
    k, v = layer_cache["k"], layer_cache["v"]
    valid = torch.arange(k.shape[1], device=x.device) < pos   # old tokens
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    s = constrain(torch.einsum("bkgd,bskd->bkgs", qf, kf),
                  "batch", None, None, "kvseq")
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    s_self = torch.einsum("bkgd,bukd->bkgu", qf, constrain(
        k_new.to(torch.float32), "batch", None, None, None))  # [B,Hkv,G,1]
    m = torch.maximum(torch.amax(s, dim=-1, keepdim=True), s_self)
    pw = torch.exp(s - m)
    p_self = torch.exp(s_self - m)                           # [B,Hkv,G,1]
    denom = torch.sum(pw, dim=-1, keepdim=True) + p_self
    o = (torch.einsum("bkgs,bskd->bkgd", pw, vf)
         + p_self * v_new.to(torch.float32)[:, 0][:, :, None])
    o = o / denom
    o = reshape(o, (B, 1, Hq * D), "batch", None, "qheads")
    out = o.to(x.dtype) @ weight_getter(p, deq)("wo").to(x.dtype)
    return out, {"k_new": k_new, "v_new": v_new}
