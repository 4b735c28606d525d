#!/usr/bin/env python3
"""Remat against no remat, and a run against the next, on one card.

The gradients of ``lm_loss`` on the smoke twins of qwen2-0.5b (dense)
and olmoe-1b-7b (MoE), at bf16 and at float32 compute, on one batch of
2 x 64 tokens: with remat, without, and with remat again.  Prints, for
each, the largest difference as a share of its leaf's largest gradient:
remat against none, and remat against remat (the card's own
run-to-run spread: the backward of a gather adds with atomics, in any
order).  ``tests/test_torch_cuda.py::test_train_step_on_card`` and
``chip_smoke.py``'s remat check are bounded from these readings.

Run from the repository root on a machine with a card:
``python3 scripts/torch_train_remat_probe.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import nvidia_smi  # noqa: E402  (also puts src/ on the path)

ARCHS = ("qwen2-0.5b", "olmoe-1b-7b")
DTYPES = ("bfloat16", "float32")
BATCH, SEQ = 2, 64


def worst(got, want) -> float:
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_remat_probe: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import dataset_for, make_batch, place_batch
    from repro_torch.models import lm_loss, model_schema
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.schema import _leaves, _unflatten, init_params

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    print(card)
    out = {}
    for arch in ARCHS:
        for cdt in DTYPES:
            cfg = dataclasses.replace(smoke_config(arch), compute_dtype=cdt)
            params = init_params(model_schema(cfg), torch.Generator(
                device=dev).manual_seed(args.seed), dev)
            batch = place_batch(make_batch(dataset_for(
                cfg, ShapeConfig("probe", SEQ, BATCH, "train"),
                args.seed), 0), dev)
            grads = []
            for remat in (True, False, True):
                live = [p.detach().requires_grad_() for p in _leaves(params)]
                loss, _ = lm_loss(_unflatten(params, live), batch, cfg,
                                  remat=remat)
                grads.append(torch.autograd.grad(loss, live))
            r = out[f"{arch} {cdt}"] = {
                "remat_vs_none": worst(grads[0], grads[1]),
                "remat_vs_remat": worst(grads[2], grads[0])}
            print(f"{arch} {cdt} compute ({card}): remat against none "
                  f"{r['remat_vs_none']:.3e}, remat against remat "
                  f"{r['remat_vs_remat']:.3e} of a leaf's largest gradient")
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
