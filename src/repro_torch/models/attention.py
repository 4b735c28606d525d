"""GQA/MQA attention: causal attention over a whole sequence (train and
prefill), and cached decode of one token.

Prefill computes each query row's softmax over the whole key row in
float32 (the reference's blockwise ``_flash`` is the same softmax taken
in blocks; with one block, as at every prompt up to 512 tokens, the two
are the same operations).  Decode attends one query against a
pre-allocated KV cache with a length mask plus an explicit self term.
"""
from __future__ import annotations

import functools

import torch

from repro_torch._build import resolve_device
from repro_torch.distributed.ctx import constrain, reshape, shard_local

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
# Causal attention over the whole prompt (prefill)
# ---------------------------------------------------------------------------
def _softmax_attend(q, k, v, *, causal: bool):
    """q [B,S,Hq,D], k/v [B,S,Hkv,D] -> [B,S,Hq,D], float32 scores.

    Query groups are laid out as the reference's blockwise attention
    anchors them (kv-heads, or when too few the groups within one, over
    model); each rank then attends its own rows and heads alone."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    q5 = ("batch", None, "kvheads", "qgroups", None)
    kv = ("batch", None, "kvheads", None)
    o = shard_local(functools.partial(_attend, causal=causal),
                    (reshape(q, (B, Sq, Hkv, Hq // Hkv, D), *q5), k, v),
                    (q5, kv, kv))
    return reshape(o, (B, Sq, Hq, D), "batch", None, "qheads",
                   None).to(q.dtype)


def _attend(q, k, v, *, causal: bool):
    """q [B,S,Hkv,G,D], k/v [B,S,Hkv,D] -> [B,S,Hkv,G,D] float32.

    The row max only shifts the exponent, and the softmax does not
    depend on it, so it is taken without a gradient path: its backward
    would be a mask of the full score tensor whose terms sum to zero."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    qf = q.to(torch.float32) * D ** -0.5
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("btkgd,bukd->btkgu", qf, kf)
    if causal:
        qp = torch.arange(Sq, device=q.device)
        kp = torch.arange(Sk, device=q.device)
        bias = torch.where(qp[:, None] >= kp[None, :], 0.0, NEG_INF)
        s = s + bias.to(torch.float32)[None, :, None, None, :]
    m = torch.clamp(torch.amax(s.detach(), dim=-1), min=NEG_INF)
    pw = torch.exp(s - m[..., None])
    denom = torch.sum(pw, dim=-1)
    o = torch.einsum("btkgu,bukd->btkgd", pw, vf)
    return o / torch.clamp(denom, min=1e-30)[..., None]


def attention(p, x, cfg: ModelConfig, *, causal: bool = True, deq=None):
    """Full attention over x (prefill).  Returns (out, (k, v))."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _project_qkv(p, x, cfg, positions, deq)
    o = _softmax_attend(q, k, v, causal=causal)
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
