"""Token-choice top-k MoE with sort-based, gather-only dispatch.

Routing and sorting happen per batch row (the GShard "group"):
assignments are sorted by expert id, ranked within their expert by a
cumulative-count subtract, dropped past the expert's capacity, and
gathered into a dense ``[B, E, C, d]`` buffer that the expert FFNs
consume as one batched einsum; the combine gathers each assignment's
slot back.  There is no scatter on the data path.

Two orderings decide which tokens an expert drops, and both follow the
reference's: the top-k breaks ties between equal probabilities towards
the lower expert index (``jax.lax.top_k``), and the sort by expert id is
stable, so tokens keep their order within an expert.  The router runs in
float32 whatever the compute dtype.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import batch_local, constrain, shard_local

from .config import ModelConfig
from .layers import _act, weight_getter
from .schema import P


def moe_schema(cfg: ModelConfig, d_ff: int | None = None):
    E, d, f = cfg.moe_experts, cfg.d_model, d_ff or cfg.d_ff
    return {
        "router": P((d, E), ("embed", None)),
        "w_gate": P((E, d, f), ("experts", "embed", "emlp")),
        "w_up": P((E, d, f), ("experts", "embed", "emlp")),
        "w_down": P((E, f, d), ("experts", "emlp", "embed")),
    }


def _capacity(cfg: ModelConfig, T: int) -> int:
    E, k = cfg.moe_experts, cfg.moe_top_k
    c = int(cfg.moe_capacity_factor * T * k / E)
    c = max(c, k, 8)
    return min(-(-c // 8) * 8, T * k)  # pad to 8


def route(router, x, k: int):
    """x [..., d] -> (probs [..., E], gate [..., k], expert [..., k]),
    all in float32; gates renormalised over the chosen k.  Equal
    probabilities go to the lower expert index first."""
    return _choose(x.to(torch.float32) @ router.to(torch.float32), k)


def _choose(logits, k: int):
    """Router logits -> (probs, gate, expert) as :func:`route`."""
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[..., :k], expert[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, expert


def _experts(p, xs, cfg: ModelConfig, get, sub: str, hidden: str):
    """Every expert's gated FFN over ``xs``: ``sub`` names its layout
    ("becd": each expert's slots; "td": all tokens) and ``hidden`` the
    hidden activations' ("becf"; "etf"), whose layout, with ``d`` for
    ``f``, the output takes.  On a mesh each rank runs its own rows and
    experts (or, with too few experts to split, its slice of the hidden
    width, the output then a partial sum)."""
    wg, wu, wd = (get(n).to(xs.dtype) for n in ("w_gate", "w_up",
                                                   "w_down"))
    w_in = ("experts", None, "emlp")
    return shard_local(
        functools.partial(_ffn, act=_act(cfg.mlp_act), sub=sub,
                          hidden=hidden),
        (xs, wg, wu, wd),
        (("batch", "experts", None, None), w_in, w_in,
         ("experts", "emlp", None)), partial_of=(3, 1))


def _ffn(xs, wg, wu, wd, *, act, sub: str, hidden: str):
    h = act(torch.einsum(f"{sub},edf->{hidden}", xs, wg))
    h = h * torch.einsum(f"{sub},edf->{hidden}", xs, wu)
    return torch.einsum(f"{hidden},efd->{hidden.replace('f', 'd')}", h, wd)


def _dispatch(x, expert, gate, *, E: int, C: int):
    """Per batch row: sort the assignments by expert (stable), rank them
    within their expert, drop those past capacity ``C`` and gather the
    kept tokens into ``[B, E, C, d]``.  Returns (dispatch buffer, each
    assignment's slot ``[B, A]``, its combine weight ``[B, A]``, zero
    where dropped)."""
    B, S, k = expert.shape
    d = x.shape[-1]
    A = S * k
    dev = x.device
    flat_e = expert.reshape(B, A)
    ar = torch.arange(A, device=dev)
    order = torch.argsort(flat_e, dim=-1, stable=True)      # [B,A]
    st = (ar // k)[order]                                   # token per pos
    iperm = torch.empty_like(order).scatter_(
        -1, order, ar.expand(B, A))                         # inverse perm

    counts = torch.zeros(B, E, dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=-1) - counts         # [B,E]

    # ---- dispatch by gather: which sorted position fills slot (e, c)?
    slots = torch.arange(C, device=dev)
    src_pos = offsets[:, :, None] + slots
    slot_valid = slots[None, None, :] < counts[:, :, None]
    src_pos = torch.clamp(src_pos, 0, A - 1).reshape(B, E * C)
    tok_for_slot = torch.gather(st, -1, src_pos)            # [B,E*C]
    disp = torch.gather(x, 1, tok_for_slot[..., None].expand(B, E * C, d))
    disp = disp * slot_valid.reshape(B, E * C, 1).to(x.dtype)

    # ---- combine plan: slot of each assignment -----------------------------
    rank_sorted = ar[None, :] - torch.gather(
        offsets, -1, torch.gather(flat_e, -1, order))       # [B,A]
    rank_j = torch.gather(rank_sorted, -1, iperm)
    keep_j = rank_j < C
    slot_j = flat_e * C + torch.where(keep_j, rank_j, 0)    # [B,A]
    w_assign = (gate.reshape(B, A) * keep_j).to(x.dtype)
    return disp.reshape(B, E, C, d), slot_j, w_assign


def _combine(out_e, slot_j, w_assign, *, k: int):
    """Per batch row: gather each assignment's expert output from its
    slot and sum a token's ``k`` weighted outputs -> ``[B, S, d]``."""
    B, E, C, d = out_e.shape
    A = slot_j.shape[1]
    contrib = torch.gather(out_e.reshape(B, E * C, d), 1,
                           slot_j[..., None].expand(B, A, d))
    return torch.sum((contrib * w_assign[..., None]).reshape(
        B, A // k, k, d), dim=2)


def moe(p, x, cfg: ModelConfig, deq=None):
    """x [B, S, d] -> (y [B, S, d], aux: the Switch load-balance loss, a
    0-d float32 tensor).  Dispatch and combine move tokens within a
    batch row only, so on a mesh they run on each rank's rows
    (``batch_local``)."""
    get = weight_getter(p, deq)
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = _capacity(cfg, S)                                   # per group

    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs, gate, expert = batch_local(functools.partial(_choose, k=k),
                                      logits, n_out=3)      # [B,S,k]
    disp, slot_j, w_assign = batch_local(
        functools.partial(_dispatch, E=E, C=C), x, expert, gate, n_out=3)
    # batch over data, experts over model (EP): expert matmuls are
    # fully local per (data, model) shard.
    disp = constrain(disp, "batch", "experts", None, None)
    out_e = constrain(_experts(p, disp, cfg, get, "becd", "becf"),
                      "batch", "experts", None, None)
    y = batch_local(functools.partial(_combine, k=k), out_e, slot_j,
                    w_assign)
    y = constrain(y, "batch", None, None)

    # Switch-style load-balance aux loss.
    top1 = expert[..., 0, None] == torch.arange(E, device=x.device)
    frac_tokens = top1.to(torch.float32).mean((0, 1))
    mean_prob = probs.mean((0, 1))
    aux = E * torch.sum(frac_tokens * mean_prob)
    return y, aux


def moe_dense_ref(p, x, cfg: ModelConfig):
    """No-drop dense plain version: every expert computes every token.
    Equal to :func:`moe` when nothing is dropped."""
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(B * S, d)
    _, gate, expert = route(p["router"], xt, k)
    out_e = _experts(p, xt, cfg, lambda n: p[n], "td", "etf")  # [E,T,d]
    mask = F.one_hot(expert, E).to(torch.float32)           # [T,k,E]
    w = torch.einsum("tk,tke->et", gate, mask).to(xt.dtype)
    y = torch.einsum("etd,et->td", out_e, w)
    return y.reshape(B, S, d)
