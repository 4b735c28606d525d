"""Core layers: norms, embeddings, rotary embedding, gated MLP, logits.

All functions are pure; parameters arrive as dict subtrees produced by
the schemas in :mod:`repro_torch.models.schema`.  Weight matmuls
optionally route through HOBFLOPS-quantized weights
(``repro_torch.quant``) by a dequant hook ``deq(name, leaf)``.
Float matmuls run in float32 with TF32 off (set by the entry points).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.ctx import constrain, grad_as_param, shard_local

from .config import ModelConfig
from .schema import P


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"float32"``, ``"bfloat16"``) as a torch
    dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_schema(d: int):
    return {"scale": P((d,), ("embed",), "ones")}


def rmsnorm(p, x, eps: float):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------
def embed_schema(cfg: ModelConfig):
    return {"table": P((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
                       "normal", scale=1.0)}


def embed(p, tokens, cfg: ModelConfig):
    """``F.embedding``, not indexing: DTensor shards an embedding lookup
    over a vocab-split table (masked partial rows) and has no rule for
    indexing one."""
    return F.embedding(tokens, grad_as_param(p["table"])).to(
        dtype_of(cfg.compute_dtype))


def logits_schema(cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"w": P((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"))}


def logits(p, x, cfg: ModelConfig, embed_params=None, deq=None):
    """x [B, S, d] -> [B, S, V] float32.  The weight is rounded to the
    activations' dtype, as the reference does; the product of two such
    values is exact in float32, so both operands go to float32 and the
    product accumulates in float32."""
    if cfg.tie_embeddings:
        w = grad_as_param(embed_params["table"]).T
    else:
        w = deq("w", p["w"]) if deq is not None else p["w"]
    lg = x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)
    return constrain(lg, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_angles(positions, d_head: int, theta: float):
    """positions [...,] int -> (cos, sin) [..., d_head//2] f32."""
    half = d_head // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    base = torch.full((), theta, dtype=torch.float32,
                      device=positions.device)    # no host-to-device copy
    freqs = torch.pow(base, -ar / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin broadcastable [..., S, 1, D//2]."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def mlp_schema(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": P((d, f), ("embed", "mlp")),
            "w_up": P((d, f), ("embed", "mlp")),
            "w_down": P((f, d), ("mlp", "embed"))}


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def weight_getter(p, deq):
    """``name -> weight`` of a parameter dict, through the dequant hook
    when one is given."""
    if deq is None:
        return lambda n: p[n]
    return lambda n: deq(n, p[n])


def mlp(p, x, cfg: ModelConfig, deq=None):
    """deq: optional weight-dequant hook (name, leaf) -> tensor, used by
    the quantized serving path."""
    get = weight_getter(p, deq)
    h = _act(cfg.mlp_act)(x @ get("w_gate").to(x.dtype))
    h = constrain(h, "batch", None, "mlp")   # Megatron column-parallel
    h = h * (x @ get("w_up").to(x.dtype))
    return h @ get("w_down").to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def softmax_xent(lg, labels):
    """lg [B,S,V], labels [B,S] int.  Mean token cross-entropy in
    float32: logsumexp minus the label's logit.

    The label's logit is picked by a gather.  The reference multiplies by
    a one-hot instead, so that GSPMD partitions the pick over a
    vocab-sharded axis; on one card that form would be a second
    ``[B, S, V]`` float32 tensor (5.0 GB a micro-batch of 2 x 4096 at
    qwen2-0.5b's vocab), and the value is the same.  DTensor logits (a
    mesh run) take :func:`_split_vocab_xent`."""
    lg = lg.to(torch.float32)
    labels = labels.to(torch.int64)
    if isinstance(lg, DTensor):
        return torch.mean(_split_vocab_xent(lg, labels))
    lse = torch.logsumexp(lg, dim=-1, keepdim=True)
    return torch.mean(lse - torch.gather(lg, -1, labels[..., None]))


def _split_vocab_xent(lg, labels):
    """Each token's loss [B,S,1] with the vocabulary left split: the
    logsumexp from the row max and the sum of exponentials (partial
    reductions of [B,S,1]), the label's logit by the reference's one-hot
    pick on each rank's slice of the vocabulary.  Gathering the logits
    whole instead costs a [B,S,V] float32 tensor a rank, several times
    over in the backward pass."""
    m = torch.amax(lg, dim=-1, keepdim=True).detach()
    lse = m + torch.log(torch.sum(torch.exp(lg - m), dim=-1, keepdim=True))
    vocab = torch.arange(lg.shape[-1], device=lg.device)
    picked = shard_local(_pick, (lg, labels, vocab),
                         (("batch", None, "vocab"), ("batch", None),
                          ("vocab",)), partial_of=(2, 0))
    return lse - picked


def _pick(lg, labels, vocab):
    """sum(lg * one_hot(labels)) over the (local) vocabulary ``vocab``."""
    return torch.sum(lg * (labels[..., None] == vocab), dim=-1, keepdim=True)
