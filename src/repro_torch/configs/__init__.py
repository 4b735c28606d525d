"""Architecture registry: the ten assigned configs + reduced smoke twins.

``get_config(name)``   — the exact published configuration.
``smoke_config(name)`` — a small model of the same family/topology for
                         CPU tests (same layer period, same block kinds).

Configs are data only; ``repro_torch.models.transformer`` interprets
them.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = {
    "grok-1-314b": "grok_1_314b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama3-405b": "llama3_405b",
    "qwen2-0.5b": "qwen2_0_5b",
    "gemma-2b": "gemma_2b",
    "qwen3-4b": "qwen3_4b",
    "internvl2-26b": "internvl2_26b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mamba2-2.7b": "mamba2_2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_IDS[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: runs a forward step on the CPU."""
    cfg = get_config(name)
    period = cfg.scan_period()
    experts = 0 if cfg.moe_experts == 0 else min(cfg.moe_experts, 8)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=period * (2 if period == 1 else 1),
        d_model=128,
        n_heads=0 if cfg.n_heads == 0 else 4,
        n_kv_heads=0 if cfg.n_heads == 0 else min(max(cfg.n_kv_heads, 1), 2),
        d_head=0 if cfg.n_heads == 0 else 32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=1024,
        moe_experts=experts,
        moe_top_k=min(cfg.moe_top_k, experts) if experts else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=1 if cfg.ssm_headdim == 1 else 8,
        ssm_chunk=32,
        enc_layers=2 if cfg.enc_layers else 0,
        num_prefix=8 if cfg.num_prefix else 0,
        frontend_dim=48 if cfg.frontend_dim else 0,
    )

