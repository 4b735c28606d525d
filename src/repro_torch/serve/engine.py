"""Batched serving engine (wave-scheduled continuous batching).

Decode runs a fixed-size batch of *slots* in lockstep so one decode step
serves every request mix.  This engine schedules in waves: up to
``n_slots`` queued requests are admitted together, prompts are padded to
the wave's common prefill length, the wave decodes in lockstep, requests
that finish early are masked out (their slots keep decoding tokens that
are discarded — the price of lockstep batching), and the next wave
starts when the wave drains.  All positions stay synchronized, which
keeps the decode step's single-position cache semantics exact.

Prefill and decode are called directly (no compilation step); the
engine runs on the device its parameters are on.  Works with quantized
(HOBFLOPS bitplane) weights through the same ``deq`` hook as everything
else.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # prompt token ids [S]
    max_new: int = 16
    eos_id: int | None = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 max_len: int = 256, deq=None, cache_dtype=torch.float32):
        if cfg.family == "encdec":
            raise ValueError("engine currently serves decoder-only families")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.deq = deq
        self.cache_dtype = cache_dtype
        self.queue: deque[Request] = deque()
        self.total_decode_steps = 0
        self.total_tokens = 0

    def submit(self, req: Request):
        self.queue.append(req)

    def _finished(self, r: Request) -> bool:
        return len(r.out) >= r.max_new or (r.eos_id is not None
                                           and r.out[-1] == r.eos_id)

    # ---- one wave -----------------------------------------------------------
    def _run_wave(self) -> list[Request]:
        wave = [self.queue.popleft()
                for _ in range(min(self.n_slots, len(self.queue)))]
        B, cfg = self.n_slots, self.cfg
        plen = max(len(r.tokens) for r in wave)
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(wave):
            # left-pad by repeating the first token: every position is a
            # real token so the causal mask stays trivially valid, and
            # generation conditions on the full prompt suffix.
            pad = plen - len(r.tokens)
            toks[i, :pad] = r.tokens[0]
            toks[i, pad:] = r.tokens
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if cfg.frontend != "none":
            batch["prefix"] = torch.zeros(
                (B, cfg.num_prefix, cfg.frontend_dim), dtype=torch.float32,
                device=self.device)

        cache, logits, pos = prefill(self.params, batch, cfg, self.max_len,
                                     dtype=self.cache_dtype, deq=self.deq)
        tok = torch.argmax(logits, -1).to(torch.int32)
        live = []
        for r, t in zip(wave, tok.tolist()):
            r.out.append(t)
            live.append(not self._finished(r))

        budget = max(r.max_new for r in wave) - 1
        for _ in range(budget):
            if pos >= self.max_len - 1 or not any(live):
                break
            logits, cache = decode_step(self.params, tok, cache, pos, cfg,
                                        deq=self.deq)
            tok = torch.argmax(logits, -1).to(torch.int32)
            nxt = tok.tolist()
            self.total_decode_steps += 1
            for i, r in enumerate(wave):
                if not live[i]:
                    continue
                r.out.append(nxt[i])
                self.total_tokens += 1
                live[i] = not self._finished(r)
            pos += 1
        for r in wave:
            r.done = True
        return wave

    def run(self) -> list[Request]:
        finished: list[Request] = []
        while self.queue:
            finished.extend(self._run_wave())
        return finished
