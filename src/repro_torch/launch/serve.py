"""Serving launcher: batched prefill + greedy decode loop.

``--quant hobflops9`` stores the targeted weight families as HOBFLOPS
bitplane codes and dequantizes them on the fly — the paper's
custom-precision FP as a serving memory-bandwidth feature.  Runs on the
card by default (``--device cpu`` runs the smoke configs on the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --quant hobflops9
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._build import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import model_schema
from repro_torch.models.schema import init_params
from repro_torch.quant.apply import quantize_params, quantized_bytes
from repro_torch.serve.steps import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_demo(cfg, *, batch: int = 2, prompt_len: int = 32,
               gen_len: int = 16, quant: str | None = None,
               seed: int = 0, print_fn=print, device="cuda", params=None,
               prompt=None, stats: dict | None = None):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    greedily to ``gen_len`` tokens each; returns the tokens
    ``[batch, gen_len]`` (numpy int32).

    Parameters come from ``init_params`` with
    ``torch.Generator().manual_seed(seed)`` and the prompt from the same
    generator, unless ``params`` (a float parameter tree on ``device``)
    or ``prompt`` (``[batch, prompt_len]`` token ids) are given; then,
    from the same generator, a VLM's prefix embeddings ``[batch,
    num_prefix, frontend_dim]`` and an enc-dec model's encoder frames
    ``[batch, prompt_len, frontend_dim]``.  With
    ``quant`` the targeted weights are stored in that HOBFLOPS format.
    ``stats``, when given, receives the times (each bounded by
    synchronising the device), the quantized footprint and every step's
    logits ``[gen_len, batch, V]``.
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = init_params(model_schema(cfg), gen, device)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                               generator=gen)
    batch_in = {"tokens": torch.as_tensor(prompt)}
    if cfg.frontend != "none" and cfg.family != "encdec":
        batch_in["prefix"] = torch.randn(
            (batch, cfg.num_prefix, cfg.frontend_dim), generator=gen)
    if cfg.family == "encdec":
        batch_in["frames"] = torch.randn(
            (batch, prompt_len, cfg.frontend_dim), generator=gen)
    batch_in = {k: v.to(device) for k, v in batch_in.items()}
    out = {} if stats is None else stats
    deq = None
    if quant:
        _sync(device)
        t = time.perf_counter()
        params, deq = quantize_params(params, cfg, quant)
        _sync(device)
        out["quantize_s"] = time.perf_counter() - t
        out["quantized_bytes"] = quantized_bytes(params)
        q, d = out["quantized_bytes"]
        print_fn(f"[serve] quantized weights to {quant} (bitplane) in "
                 f"{out['quantize_s']:.3f} s: {q} bytes against {d} in "
                 f"bf16")

    max_len = prompt_len + gen_len + cfg.num_prefix
    prefill = make_prefill_step(cfg, max_len, deq=deq)
    step = make_decode_step(cfg, deq=deq)

    _sync(device)
    t0 = time.perf_counter()
    cache, logits, length = prefill(params, batch_in)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    print_fn(f"[serve] prefill {prompt_len} tokens x{batch}: "
             f"{out['prefill_ms']:.2f} ms")

    toks, all_logits = [tok], [logits]
    t1 = time.perf_counter()
    for i in range(gen_len - 1):
        tok, logits, cache = step(params, tok, length + i, cache)
        toks.append(tok)
        all_logits.append(logits)
    _sync(device)
    dt = time.perf_counter() - t1
    steps = gen_len - 1
    out["decode_ms_per_step"] = dt * 1e3 / max(steps, 1)
    out["tok_s"] = batch * steps / max(dt, 1e-9)
    out["logits"] = torch.stack(all_logits)
    tokens = torch.stack(toks, 1).cpu().numpy()
    print_fn(f"[serve] decoded {steps} steps x{batch} in {dt * 1e3:.2f} ms "
             f"({out['decode_ms_per_step']:.2f} ms/step, "
             f"{out['tok_s']:.1f} tok/s)")
    print_fn(f"[serve] sample output ids: {tokens[0][:12].tolist()}")
    return tokens


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--quant", default=None,
                    help="e.g. hobflops9 — bitplane weight storage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    serve_demo(cfg, batch=args.batch, prompt_len=args.prompt_len,
               gen_len=args.gen_len, quant=args.quant, device=args.device)


if __name__ == "__main__":
    main()
