"""Model assembly: decoder-only / hybrid / MoE / SSM / enc-dec / VLM.

One code path serves all ten architectures.  The layer stack is grouped
into *super-layers* of ``cfg.scan_period()`` blocks (the smallest
repeating pattern of (attention?, moe?) kinds) whose parameters are
stacked along a leading depth axis under ``blocks/b<k>`` (the
reference's tree, so ``repro_torch.convert`` maps one onto the other by
name).  The reference's ``lax.scan`` over depth is a Python loop here
over the layers of every leaf (``unstack``).

Caches (decode) and the per-segment KV and SSM state (prefill) mirror
the block structure.  Training (``lm_loss``) runs the stack in train
mode: nothing is cached, and each super-layer's body is rematerialized
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.ctx import (constrain, get_act_rules, reshape,
                                         write_rows)
from repro_torch.quant.storage import QuantizedTensor

from .attention import (_flash, attention, attn_schema,
                        decode_attention, init_kv_cache)
from .config import ModelConfig
from .layers import (dtype_of, embed, embed_schema, logits, logits_schema,
                     mlp, mlp_schema, rmsnorm, rmsnorm_schema, softmax_xent,
                     weight_getter)
from .mamba import mamba, mamba_decode, mamba_init_state, mamba_schema
from .moe import moe, moe_schema
from .schema import P, stack

Tree = Any


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------
def block_schema(cfg: ModelConfig, kind: tuple[bool, bool],
                 cross: bool = False) -> Tree:
    is_attn, is_moe = kind
    d = cfg.d_model
    s: dict = {"pre_norm": rmsnorm_schema(d)}
    if is_attn:
        s["attn"] = attn_schema(cfg)
    else:
        s["mamba"] = mamba_schema(cfg)
    if cross:
        s["cross_norm"] = rmsnorm_schema(d)
        s["cross"] = attn_schema(cfg)
    if cfg.d_ff > 0:
        s["mlp_norm"] = rmsnorm_schema(d)
        s["moe" if is_moe else "mlp"] = (
            moe_schema(cfg) if is_moe else mlp_schema(cfg))
    return s


def model_schema(cfg: ModelConfig) -> Tree:
    period = cfg.scan_period()
    depth = cfg.n_layers // period
    kinds = cfg.layer_kinds()[:period]
    cross = cfg.family == "encdec"
    s: dict = {"embed": embed_schema(cfg)}
    s["blocks"] = {f"b{k}": stack(block_schema(cfg, kinds[k], cross), depth)
                   for k in range(period)}
    s["final_norm"] = rmsnorm_schema(cfg.d_model)
    s["logits"] = logits_schema(cfg)
    if cfg.frontend != "none":
        s["frontend"] = {"proj": P((cfg.frontend_dim, cfg.d_model),
                                   (None, "embed"))}
    if cfg.family == "encdec":
        s["enc_blocks"] = {"e0": stack(block_schema(cfg, (True, False)),
                                       cfg.enc_layers)}
        s["enc_norm"] = rmsnorm_schema(cfg.d_model)
    return s


def unstack(tree: Tree, depth: int) -> list[Tree]:
    """A stacked subtree as one tree a layer.  A tensor leaf is unbound
    once, so that the backward pass gathers its layers' gradients in one
    node (a slice a layer would add a zero-padded, depth-sized gradient
    for every layer); a quantized leaf is sliced by its ``layer``."""
    if isinstance(tree, dict):
        per = {k: unstack(v, depth) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(depth)]
    if isinstance(tree, QuantizedTensor):
        return [tree.layer(i) for i in range(depth)]
    return torch.unbind(tree, 0)


# ---------------------------------------------------------------------------
# Cross attention (enc-dec): no RoPE, bidirectional over memory.
# ---------------------------------------------------------------------------
def cross_kv(p, memory, cfg: ModelConfig, deq=None):
    get = weight_getter(p, deq)
    B = memory.shape[0]
    k = memory @ get("wk").to(memory.dtype)
    v = memory @ get("wv").to(memory.dtype)
    dh = cfg.head_dim
    shape = (B, memory.shape[1], cfg.n_kv_heads, dh)
    return (reshape(k, shape, "batch", None, "kvheads", None),
            reshape(v, shape, "batch", None, "kvheads", None))


def cross_attention(p, x, kv, cfg: ModelConfig, deq=None):
    """x [B,T,d] queries over precomputed memory (k, v)."""
    get = weight_getter(p, deq)
    B, T, _ = x.shape
    q = reshape(x @ get("wq").to(x.dtype), (B, T, cfg.n_heads, cfg.head_dim),
                "batch", None, "qheads", None)
    o = _flash(q, *kv, causal=False, q_block=512, kv_block=512)
    o = reshape(o, (B, T, cfg.n_heads * cfg.head_dim), "batch", None,
                "qheads")
    return o @ get("wo").to(x.dtype)


# ---------------------------------------------------------------------------
# Block application (one of the `period` positions)
# ---------------------------------------------------------------------------
def apply_block(bp, x, cfg: ModelConfig, kind, *, mode: str, cache=None,
                pos: int | None = None, memory=None, causal: bool = True,
                deq=None):
    """Returns (x, aux, cache_out); aux is the MoE balance loss (0.0 for
    a block without MoE).  mode: train | prefill | decode.

    cache_out: for train and prefill, this block's fresh cache entries
    (KV of the processed segment, final SSM state, cross KV of the
    memory; the train stack drops them); for decode, the token's
    ``k_new``/``v_new`` or the new SSM state.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: one of train | prefill | decode")
    is_attn, is_moe = kind
    aux = 0.0
    cache_out = {}
    # Each mixer and FFN input leaves the sequence-parallel layout (the
    # Megatron all-gather): a DTensor view cannot merge a sharded
    # sequence dim into the rows of a matmul.
    h = constrain(rmsnorm(bp["pre_norm"], x, cfg.norm_eps),
                  "batch", None, None)
    if is_attn:
        if mode == "decode":
            a, new_kv = decode_attention(bp["attn"], h, cfg, cache, pos,
                                         deq=deq)
            cache_out.update(new_kv)
        else:
            a, (k, v) = attention(bp["attn"], h, cfg, causal=causal, deq=deq)
            cache_out.update({"k": k, "v": v})
    elif mode == "decode":
        a, cache_out = mamba_decode(bp["mamba"], h, cfg,
                                    {"conv": cache["conv"],
                                     "ssd": cache["ssd"]}, deq=deq)
    else:
        a, cache_out = mamba(bp["mamba"], h, cfg, deq=deq)
    # ... and each output re-enters it before the residual add (the
    # Megatron reduce-scatter), so that its gradient leaves it again.
    x = x + constrain(a, "batch", "act_seq", None)
    if "cross" in bp:
        hc = constrain(rmsnorm(bp["cross_norm"], x, cfg.norm_eps),
                       "batch", None, None)
        if mode == "decode":
            kv = (cache["ck"], cache["cv"])   # read-only at decode
        else:
            kv = cross_kv(bp["cross"], memory, cfg, deq=deq)
            cache_out.update({"ck": kv[0], "cv": kv[1]})
        x = x + constrain(cross_attention(bp["cross"], hc, kv, cfg, deq=deq),
                          "batch", "act_seq", None)
    if cfg.d_ff > 0:
        h = constrain(rmsnorm(bp["mlp_norm"], x, cfg.norm_eps),
                      "batch", None, None)
        if is_moe:
            y, aux = moe(bp["moe"], h, cfg, deq=deq)
        else:
            y = mlp(bp["mlp"], h, cfg, deq=deq)
        x = x + constrain(y, "batch", "act_seq", None)
    return x, aux, cache_out


def apply_stack(blocks, x, cfg: ModelConfig, *, mode: str, caches=None,
                pos: int | None = None, memory=None, causal: bool = True,
                deq=None, kinds=None, remat: bool | None = None):
    """blocks: {"b<k>": stacked subtree}; caches mirrors blocks (decode)
    or is None.  Returns (x, aux, caches_out) with each block's outputs
    stacked along depth; in train mode caches_out is ``{}``.

    ``remat`` (default: train mode) runs each super-layer's body under
    non-reentrant ``torch.utils.checkpoint``: the backward pass
    recomputes its activations instead of keeping them.  The recomputed
    forward is the same computation (MoE routing sorts stably, so it
    picks the same experts)."""
    keys = [f"b{k}" for k in range(len(blocks))]
    if kinds is None:
        kinds = cfg.layer_kinds()[:len(keys)]
    if remat is None:
        remat = mode == "train"
    depth = blocks[keys[0]]["pre_norm"]["scale"].shape[0]
    layers = {key: unstack(blocks[key], depth) for key in keys}
    cache_layers = (None if caches is None else
                    {key: unstack(caches[key], depth) for key in keys})

    def body(i, x, aux):
        # Residual anchor: batch over data, seq over model (Megatron
        # sequence parallelism) when the rules context enables it.
        x = constrain(x, "batch", "act_seq", None)
        outs = {}
        for key, kind in zip(keys, kinds):
            c = None if cache_layers is None else cache_layers[key][i]
            x, a, outs[key] = apply_block(
                layers[key][i], x, cfg, kind, mode=mode, cache=c, pos=pos,
                memory=memory, causal=causal, deq=deq)
            aux = aux + a
        return x, aux, outs

    aux = 0.0
    outs = {key: [] for key in keys}
    for i in range(depth):
        if remat:
            x, aux, co = checkpoint(body, i, x, aux, use_reentrant=False)
        else:
            x, aux, co = body(i, x, aux)
        if mode != "train":
            for key in keys:
                outs[key].append(co[key])
    if mode == "train":
        return x, aux, {}
    stacked = {key: {n: torch.stack([o[n] for o in outs[key]])
                     for n in outs[key][0]} for key in keys}
    return x, aux, stacked


# ---------------------------------------------------------------------------
# Embedding front: tokens (+ prefix embeds for VLM)
# ---------------------------------------------------------------------------
def _embed_input(params, batch, cfg: ModelConfig):
    """-> (x [B, S_total, d], n_prefix)."""
    x = embed(params["embed"], batch["tokens"], cfg)
    n_prefix = 0
    if cfg.frontend != "none" and cfg.family != "encdec":
        prefix = batch["prefix"].to(x.dtype)
        proj = params["frontend"]["proj"].to(x.dtype)
        # On a mesh both halves are reduced to one layout first (DTensor
        # cannot join the lookup's masked partial rows with a product's
        # partial sums).
        x = torch.cat([constrain(prefix @ proj, "batch", None, None),
                       constrain(x, "batch", None, None)], dim=1)
        n_prefix = prefix.shape[1]
    return constrain(x, "batch", "act_seq", None), n_prefix


def encode_memory(params, batch, cfg: ModelConfig, remat: bool = False):
    """Enc-dec encoder: frames [B,Se,F] -> memory [B,Se,d], its layers
    rematerialized with ``remat`` (train mode).  Like the reference's,
    it runs without the dequant hook."""
    cdt = dtype_of(cfg.compute_dtype)
    x = batch["frames"].to(cdt) @ params["frontend"]["proj"].to(cdt)
    x, _, _ = apply_stack({"b0": params["enc_blocks"]["e0"]}, x, cfg,
                          mode="train" if remat else "prefill",
                          causal=False, kinds=[(True, False)], remat=remat)
    return constrain(rmsnorm(params["enc_norm"], x, cfg.norm_eps),
                     "batch", None, None)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def forward_logits(params, batch, cfg: ModelConfig, *, mode: str = "train",
                   deq=None, remat: bool | None = None):
    """-> (logits [B, S_text, V] float32, aux).  ``remat`` (default:
    train mode) rematerializes the decoder's and the encoder's layers."""
    if remat is None:
        remat = mode == "train"
    x, n_prefix = _embed_input(params, batch, cfg)
    memory = (encode_memory(params, batch, cfg, remat=remat)
              if cfg.family == "encdec" else None)
    x, aux, _ = apply_stack(params["blocks"], x, cfg, mode=mode,
                            memory=memory, deq=deq, remat=remat)
    x = constrain(rmsnorm(params["final_norm"], x[:, n_prefix:, :],
                          cfg.norm_eps), "batch", None, None)
    lg = logits(params.get("logits", {}), x, cfg,
                embed_params=params["embed"], deq=deq)
    return lg, aux


def lm_loss(params, batch, cfg: ModelConfig, aux_weight: float = 0.01,
            remat: bool = True):
    """-> (total, {"xent", "aux"}): the mean token cross-entropy of a
    train-mode forward plus ``aux_weight`` times the MoE balance loss,
    all 0-d float32 tensors.  ``remat=False`` keeps every layer's
    activations (the plain version the remat checks compare with)."""
    lg, aux = forward_logits(params, batch, cfg, mode="train", remat=remat)
    loss = softmax_xent(lg, batch["labels"])
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    total = loss + aux_weight * aux
    return total, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               dtype=torch.bfloat16, device="cuda", mesh=None) -> Tree:
    """Per block position: ``k``/``v`` [depth, B, max_len, Hkv, D] for
    attention, ``conv`` [depth, B, K-1, conv_dim] and ``ssd`` (float32
    whatever ``dtype``) for Mamba, ``ck``/``cv`` [depth, B, enc_len, Hkv,
    D] for enc-dec.  With a ``mesh`` every leaf is a DTensor of zeros laid
    out by ``cache_pspecs`` under the installed activation rules, each
    rank allocating only its shard."""
    if mesh is not None:
        return _mesh_cache(cfg, batch, max_len, enc_len, dtype, device, mesh)
    period = cfg.scan_period()
    depth = cfg.n_layers // period
    kinds = cfg.layer_kinds()[:period]

    def one(kind):
        is_attn, _ = kind
        if is_attn:
            c = init_kv_cache(cfg, batch, max_len, depth, dtype, device)
        else:
            st = mamba_init_state(cfg, batch, dtype, device)
            c = {n: t[None].repeat(depth, *(1,) * t.ndim)
                 for n, t in st.items()}
        if cfg.family == "encdec":
            ckv = init_kv_cache(cfg, batch, enc_len, depth, dtype, device)
            c.update(ck=ckv["k"], cv=ckv["v"])
        return c

    return {f"b{k}": one(kinds[k]) for k in range(period)}


def _mesh_cache(cfg, batch, max_len, enc_len, dtype, device, mesh) -> Tree:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.distributed.sharding import cache_pspecs, placements
    rules = get_act_rules()
    if rules is None:
        raise ValueError("a cache on a mesh needs activation rules "
                         "(distributed.ctx.act_rules)")
    shapes = init_cache(cfg, batch, max_len, enc_len, dtype, device="meta")
    specs = cache_pspecs(shapes, rules)

    def leaf(t, spec):
        pl = placements(mesh, spec)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return DTensor.from_local(
            torch.zeros(local, dtype=t.dtype, device=device), mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())

    return {key: {n: leaf(t, specs[key][n]) for n, t in c.items()}
            for key, c in shapes.items()}


def prefill(params, batch, cfg: ModelConfig, max_len: int,
            dtype=torch.bfloat16, deq=None):
    """Process the prompt; build a max_len cache.  Returns
    (cache, last_logits [B, V], prompt length with the prefix)."""
    x, _ = _embed_input(params, batch, cfg)
    memory = (encode_memory(params, batch, cfg)
              if cfg.family == "encdec" else None)
    S = x.shape[1]
    x, _, fresh = apply_stack(params["blocks"], x, cfg, mode="prefill",
                              memory=memory, deq=deq)
    xl = constrain(rmsnorm(params["final_norm"], x[:, -1:, :],
                           cfg.norm_eps), "batch", None, None)
    lg = logits(params.get("logits", {}), xl, cfg,
                embed_params=params["embed"], deq=deq)[:, 0, :]
    cache = init_cache(cfg, x.shape[0], max_len,
                       enc_len=0 if memory is None else memory.shape[1],
                       dtype=dtype, device=x.device,
                       mesh=getattr(x, "device_mesh", None))
    for key, c in cache.items():
        for name, dst in c.items():
            if name in ("k", "v"):
                write_rows(dst, fresh[key][name], 0, 2)
            else:
                dst.copy_(fresh[key][name])
    return cache, lg, S


def decode_step(params, token, cache, pos: int, cfg: ModelConfig,
                deq=None):
    """token [B] int; pos (current cache length).  Returns (logits
    [B, V], cache).

    The layer loop reads the cache; the fresh per-layer ``k``/``v`` and
    SSM states come back stacked and are written once per cache tensor,
    IN PLACE: the returned cache is the one passed in (the reference
    returns an updated copy; a copy here would move the whole cache
    every step).  ``ck``/``cv`` are read-only."""
    x = embed(params["embed"], token[:, None], cfg)
    x, _, outs = apply_stack(params["blocks"], x, cfg, mode="decode",
                             caches=cache, pos=pos, deq=deq)
    for key, c in cache.items():
        o = outs[key]
        if "k_new" in o:
            write_rows(c["k"], o["k_new"].to(c["k"].dtype), pos, 2)
            write_rows(c["v"], o["v_new"].to(c["v"].dtype), pos, 2)
        if "conv" in o:
            c["conv"].copy_(o["conv"])
            c["ssd"].copy_(o["ssd"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    lg = logits(params.get("logits", {}), x, cfg,
                embed_params=params["embed"], deq=deq)[:, 0, :]
    return lg, cache
