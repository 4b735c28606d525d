"""Model assembly for the dense decoder-only family.

The layer stack is grouped into *super-layers* of ``cfg.scan_period()``
blocks whose parameters are stacked along a leading depth axis under
``blocks/b<k>`` (the reference's tree, so ``repro_torch.convert`` maps
one onto the other by name).  The reference's ``lax.scan`` over depth
is a Python loop here that slices layer ``i`` of every leaf.

Only the dense family runs: a config whose blocks need MoE, Mamba,
cross-attention or a modality frontend raises ``NotImplementedError``
(ROADMAP queue 1 item 8 ports them).  Training (``lm_loss``, remat)
waits for the training slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.quant.storage import QuantizedTensor

from .attention import (attention, attn_schema, decode_attention,
                        init_kv_cache)
from .config import ModelConfig
from .layers import (embed, embed_schema, logits, logits_schema, mlp,
                     mlp_schema, rmsnorm, rmsnorm_schema)
from .schema import stack

Tree = Any


def require_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every block of ``cfg`` is a
    dense attention + MLP block without a frontend."""
    needs = []
    if cfg.moe_experts:
        needs.append("MoE")
    if any(not attn for attn, _ in cfg.layer_kinds()):
        needs.append("Mamba")
    if cfg.family == "encdec":
        needs.append("cross-attention")
    if cfg.frontend != "none":
        needs.append("a modality frontend")
    if needs:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(needs)} blocks; the port runs the "
            f"dense family only (ROADMAP queue 1 item 8 ports the rest)")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------
def block_schema(cfg: ModelConfig) -> Tree:
    require_dense(cfg)
    d = cfg.d_model
    s: dict = {"pre_norm": rmsnorm_schema(d), "attn": attn_schema(cfg)}
    if cfg.d_ff > 0:
        s["mlp_norm"] = rmsnorm_schema(d)
        s["mlp"] = mlp_schema(cfg)
    return s


def model_schema(cfg: ModelConfig) -> Tree:
    require_dense(cfg)
    period = cfg.scan_period()
    depth = cfg.n_layers // period
    return {"embed": embed_schema(cfg),
            "blocks": {f"b{k}": stack(block_schema(cfg), depth)
                       for k in range(period)},
            "final_norm": rmsnorm_schema(cfg.d_model),
            "logits": logits_schema(cfg)}


def layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked subtree (tensors and quantized leaves)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.layer(i)
    return tree[i]


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def apply_block(bp, x, cfg: ModelConfig, *, mode: str, cache=None,
                pos: int | None = None, deq=None):
    """Returns (x, aux, cache_out); aux (the MoE balance loss) is 0.0
    for a dense block.  mode: prefill | decode.

    cache_out: for prefill, this block's KV of the processed segment;
    for decode, the fresh ``k_new``/``v_new`` of the token.
    """
    h = rmsnorm(bp["pre_norm"], x, cfg.norm_eps)
    if mode == "decode":
        a, cache_out = decode_attention(bp["attn"], h, cfg, cache, pos,
                                        deq=deq)
    elif mode == "prefill":
        a, (k, v) = attention(bp["attn"], h, cfg, deq=deq)
        cache_out = {"k": k, "v": v}
    else:
        raise ValueError(f"mode {mode!r}: the port serves (prefill | "
                         f"decode); training waits for its slice")
    x = x + a
    if cfg.d_ff > 0:
        h = rmsnorm(bp["mlp_norm"], x, cfg.norm_eps)
        x = x + mlp(bp["mlp"], h, cfg, deq=deq)
    return x, 0.0, cache_out


def apply_stack(blocks, x, cfg: ModelConfig, *, mode: str, caches=None,
                pos: int | None = None, deq=None):
    """blocks: {"b<k>": stacked subtree}; caches mirrors blocks (decode)
    or is None.  Returns (x, aux, caches_out) with each block's outputs
    stacked along depth."""
    keys = [f"b{k}" for k in range(len(blocks))]
    depth = blocks[keys[0]]["pre_norm"]["scale"].shape[0]
    aux = 0.0
    outs = {key: [] for key in keys}
    for i in range(depth):
        for key in keys:
            c = None if caches is None else layer(caches[key], i)
            x, a, co = apply_block(layer(blocks[key], i), x, cfg, mode=mode,
                                   cache=c, pos=pos, deq=deq)
            aux = aux + a
            outs[key].append(co)
    stacked = {key: {n: torch.stack([o[n] for o in outs[key]])
                     for n in outs[key][0]} for key in keys}
    return x, aux, stacked


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def _embed_input(params, batch, cfg: ModelConfig):
    """-> (x [B, S, d], n_prefix)."""
    require_dense(cfg)
    return embed(params["embed"], batch["tokens"], cfg), 0


def forward_logits(params, batch, cfg: ModelConfig, *, deq=None):
    """-> (logits [B, S, V] float32, aux)."""
    x, _ = _embed_input(params, batch, cfg)
    x, aux, _ = apply_stack(params["blocks"], x, cfg, mode="prefill",
                            deq=deq)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    lg = logits(params.get("logits", {}), x, cfg,
                embed_params=params["embed"], deq=deq)
    return lg, aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Tree:
    require_dense(cfg)
    period = cfg.scan_period()
    return {f"b{k}": init_kv_cache(cfg, batch, max_len,
                                   cfg.n_layers // period, dtype, device)
            for k in range(period)}


def prefill(params, batch, cfg: ModelConfig, max_len: int,
            dtype=torch.bfloat16, deq=None):
    """Process the prompt; build a max_len cache.  Returns
    (cache, last_logits [B, V], prompt length)."""
    x, _ = _embed_input(params, batch, cfg)
    S = x.shape[1]
    x, _, fresh = apply_stack(params["blocks"], x, cfg, mode="prefill",
                              deq=deq)
    xl = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    lg = logits(params.get("logits", {}), xl, cfg,
                embed_params=params["embed"], deq=deq)[:, 0, :]
    cache = init_cache(cfg, x.shape[0], max_len, dtype=dtype,
                       device=x.device)
    for key, c in cache.items():
        for name in ("k", "v"):
            c[name][:, :, :S] = fresh[key][name].to(dtype)
    return cache, lg, S


def decode_step(params, token, cache, pos: int, cfg: ModelConfig,
                deq=None):
    """token [B] int; pos (current cache length).  Returns (logits
    [B, V], cache).

    The layer loop reads the cache; the fresh per-layer (k, v) come
    back stacked and are written at ``pos`` once per cache tensor, IN
    PLACE: the returned cache is the one passed in (the reference
    returns an updated copy; a copy here would move the whole cache
    every step)."""
    x = embed(params["embed"], token[:, None], cfg)
    x, _, outs = apply_stack(params["blocks"], x, cfg, mode="decode",
                             caches=cache, pos=pos, deq=deq)
    for key, c in cache.items():
        c["k"][:, :, pos:pos + 1] = outs[key]["k_new"].to(c["k"].dtype)
        c["v"][:, :, pos:pos + 1] = outs[key]["v_new"].to(c["v"].dtype)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    lg = logits(params.get("logits", {}), x, cfg,
                embed_params=params["embed"], deq=deq)[:, 0, :]
    return lg, cache
