"""Smoke-size twins of the cells, for checks on the CPU: every width
small, the same configuration and mix keys."""
from __future__ import annotations

import copy

from harness import core


def conv_cell(man=None):
    w, cfg, mix = core.cell(man or core.manifest(), "conv-h9.closed128")
    cfg, mix = copy.deepcopy(cfg), dict(mix)
    cfg["input_hwc"] = [6, 6, 32]
    for layer in cfg["layers"]:
        layer["cin"] = layer["cout"] = 32
    cfg["max_batch"] = 4
    mix.update(clients=8, pool=16, warmup_waves=1)
    return w, cfg, mix


def lm_cell(man=None):
    w, cfg, mix = core.cell(man or core.manifest(), "olmoe-h9.decode32")
    cfg, mix = copy.deepcopy(cfg), dict(mix)
    cfg.update(hidden_size=64, intermediate_size=32, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=4, num_experts=8,
               num_experts_per_tok=2, vocab_size=300)
    mix.update(batch=4, prompt_median=12, prompt_min=4, prompt_max=20,
               gen_positions=6, check_sequences=4, trace_seconds=0.3)
    return w, cfg, mix
