"""Deterministic synthetic data pipeline.

Batches are a pure function of (seed, step) — no files, no state.  That
is exactly what restart-from-checkpoint needs: a restored step counter
reproduces the identical data stream on any number of hosts, and each
host materializes only what it places (``place_batch``), so the
pipeline is elastic by construction.  The numpy code is the
reference's, so both packages make bit-identical batches.

The token stream is a order-3 LCG-mixed sequence: cheap, seeded, with
enough structure that cross-entropy decreases visibly during the
example training runs (unlike iid-uniform tokens, which are unlearnable
beyond the unigram floor).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # model-input extras (modality stubs)
    num_prefix: int = 0
    frontend_dim: int = 0
    frames: bool = False

    def batch_at(self, step: int) -> dict:
        return make_batch(self, step)


def _token_stream(ds: SyntheticLM, step: int) -> np.ndarray:
    """[B, S+1] int32.  Learnable structure: next token is a mix of an
    LCG of the previous token and a slowly-varying per-row offset."""
    B, S, V = ds.global_batch, ds.seq_len, ds.vocab
    rng = np.random.default_rng((ds.seed, step))
    x = np.empty((B, S + 1), dtype=np.int64)
    x[:, 0] = rng.integers(0, V, size=B)
    row = rng.integers(0, V, size=(B, 1))
    noise = rng.integers(0, V, size=(B, S))
    noisy = rng.random((B, S)) < 0.1
    for t in range(S):
        nxt = (x[:, t] * 1103515245 + 12345 + row[:, 0]) % V
        x[:, t + 1] = np.where(noisy[:, t], noise[:, t], nxt)
    return x.astype(np.int32)


def make_batch(ds: SyntheticLM, step: int) -> dict:
    toks = _token_stream(ds, step)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rng = np.random.default_rng((ds.seed, step, 1))
    if ds.num_prefix:
        batch["prefix"] = rng.standard_normal(
            (ds.global_batch, ds.num_prefix, ds.frontend_dim),
            dtype=np.float32)
    if ds.frames:
        batch["frames"] = rng.standard_normal(
            (ds.global_batch, ds.seq_len, ds.frontend_dim), dtype=np.float32)
    return batch


def place_batch(batch: dict, device) -> dict:
    """Host batch -> tensors on ``device``: ``tokens`` and ``labels`` as
    int64 (what ``embed`` and the loss index with), the float inputs
    (``prefix``, ``frames``) as float32."""
    return {name: torch.from_numpy(arr).to(
                device, torch.int64 if arr.dtype.kind == "i" else
                torch.float32)
            for name, arr in batch.items()}


def dataset_for(cfg, shape, seed: int = 0) -> SyntheticLM:
    """Dataset matching a (ModelConfig, ShapeConfig) cell."""
    return SyntheticLM(
        vocab=cfg.vocab, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        num_prefix=cfg.num_prefix if cfg.family != "encdec" else 0,
        frontend_dim=cfg.frontend_dim,
        frames=cfg.family == "encdec")
