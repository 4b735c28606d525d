"""Serve a small LM with batched requests on the PyTorch/CUDA port,
weights stored as HOBFLOPS9 bitplane codes — the paper's
custom-precision FP as the memory-bandwidth feature of decode.
Compares output agreement and weight footprint against bf16.

The port's counterpart of ``examples/serve_quantized.py`` (the qwen3-4b
smoke twin).  Runs on the card by default; ``--device cpu`` runs it on
the CPU.

Run: PYTHONPATH=src python examples/serve_quantized_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch

from repro_torch._build import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.launch.serve import serve_demo
from repro_torch.models import model_schema
from repro_torch.models.schema import init_params
from repro_torch.quant.apply import quantize_params, quantized_bytes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = smoke_config("qwen3-4b")
    print(f"arch: {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) on {device}")

    params = init_params(model_schema(cfg), torch.Generator().manual_seed(0),
                         device)
    qp, _ = quantize_params(params, cfg, "hobflops9")
    qb, db = quantized_bytes(qp)
    print(f"quantized weight families: {qb/1e6:.2f} MB as hobflops9 "
          f"bitplanes vs {db/1e6:.2f} MB as bf16 "
          f"({db/max(qb,1):.2f}x smaller)\n")

    print("--- serving with bf16 weights ---")
    toks_f = serve_demo(cfg, batch=4, prompt_len=32, gen_len=12,
                        device=device)
    print("\n--- serving with hobflops9 bitplane weights ---")
    toks_q = serve_demo(cfg, batch=4, prompt_len=32, gen_len=12,
                        quant="hobflops9", device=device)
    agree = (toks_f == toks_q).mean()
    print(f"\ngreedy token agreement f32 vs hobflops9: {agree:.2%} "
          f"(9-bit weights on an untrained model)")


if __name__ == "__main__":
    main()
