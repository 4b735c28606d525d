"""Architecture registry: the ten assigned configs + reduced smoke twins.

``get_config(name)``   — the exact published configuration.
``smoke_config(name)`` — a small model of the same family/topology for
                         CPU tests (same layer period, same block kinds).
``input_specs(...)``   — meta-device stand-ins for every model input of
                         a (config, shape, mode) cell; nothing is
                         allocated (the dry-run contract).

Configs are data only; ``repro_torch.models.transformer`` interprets
them.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig

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
ARCH_NAMES = list(ARCH_IDS)


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




# ---------------------------------------------------------------------------
# Input specs (abstract batches) per (config, shape, mode)
# ---------------------------------------------------------------------------
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, train: bool):
    """Token batch as meta tensors (the data-pipeline contract)."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((B, S), torch.int32)}
    if train:
        specs["labels"] = _meta((B, S), torch.int32)
    if cfg.frontend != "none" and cfg.family != "encdec":
        specs["prefix"] = _meta((B, cfg.num_prefix, cfg.frontend_dim),
                                torch.float32)
    if cfg.family == "encdec":
        specs["frames"] = _meta((B, S, cfg.frontend_dim), torch.float32)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16):
    """Abstract KV/SSM cache for a decode cell (nothing allocated)."""
    from repro_torch.models.transformer import init_cache
    max_len = shape.seq_len + cfg.num_prefix
    enc_len = shape.seq_len if cfg.family == "encdec" else 0
    return init_cache(cfg, shape.global_batch, max_len, enc_len=enc_len,
                      dtype=dtype, device="meta")


def decode_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Inputs of one serve_step: (token, pos, cache)."""
    return {
        "token": _meta((shape.global_batch,), torch.int32),
        "pos": _meta((), torch.int32),
        "cache": cache_specs(cfg, shape),
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mode: str):
    """mode: train | prefill | decode."""
    if mode == "train":
        return {"batch": batch_specs(cfg, shape, train=True)}
    if mode == "prefill":
        return {"batch": batch_specs(cfg, shape, train=False)}
    if mode == "decode":
        return decode_specs(cfg, shape)
    raise ValueError(mode)
