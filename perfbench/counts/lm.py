"""Frozen model FLOPs of a decoder-only MoE LM step (a configuration's
sizes), for ``lm.mfu``.

A generated token costs 2 FLOPs an active parameter: the attention
projections (d x (Hq + 2 Hkv) x head + Hq x head x d), the router
(d x E), ``num_experts_per_tok`` of the experts (3 x d x f each) in every
layer, and the logits head over the published vocabulary (d x V):
1.1789 G for ``olmoe-1b-7b-h9``.  Causal attention adds its score and
value products, 4 x d x (positions attended) a layer: a token at
position p attends p + 1 positions.  The embedding lookup and the norms
are not counted.  Peaks: ``h100.json``."""
from __future__ import annotations


def active_params(cfg: dict) -> int:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // hq
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    layer = d * (hq + 2 * hkv) * dh + hq * dh * d + d * e + k * 3 * d * f
    return cfg["num_hidden_layers"] * layer + d * cfg["vocab_size"]


def flops(cfg: dict, tokens: int, attended: int) -> float:
    """``tokens`` generated, attending ``attended`` positions in all."""
    return 2.0 * active_params(cfg) * tokens \
        + 4.0 * cfg["hidden_size"] * cfg["num_hidden_layers"] * attended
