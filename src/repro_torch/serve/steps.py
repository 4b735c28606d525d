"""Serving steps: prefill and single-token decode, with optional
HOBFLOPS-quantized weights (the paper's custom-precision FP as the
memory-bandwidth lever of decode).

Decode is the memory-bound phase: every step reads all weights plus the
KV cache once.  With quantized weights, the targeted weight families
are held in HOBFLOPS bitplane codes (exactly nbits bits per weight in
device memory) and dequantized on the fly through the ``deq`` hook.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.ctx import constrain
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_len: int, deq=None):
    def prefill_step(params, batch):
        cache, last_logits, length = prefill(params, batch, cfg, max_len,
                                             deq=deq)
        return cache, last_logits, length
    return prefill_step


def make_decode_step(cfg: ModelConfig, deq=None, sample: str = "greedy"):
    if sample != "greedy":
        raise ValueError(sample)

    def serve_step(params, token, pos, cache):
        logits, new_cache = decode_step(params, token, cache, pos, cfg,
                                        deq=deq)
        # On a mesh the vocabulary is gathered first: DTensor's split
        # argmax gathers through a view that a fake process group fails.
        nxt = torch.argmax(constrain(logits, "batch", None),
                           dim=-1).to(torch.int32)
        return nxt, logits, new_cache
    return serve_step
