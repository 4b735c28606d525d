"""Train a small LM on the synthetic pipeline with checkpoint/restart,
on the PyTorch/CUDA port.

The port's counterpart of ``examples/train_lm.py``: remat'd layers,
AdamW + warmup-cosine, async checkpoints, heartbeats, and crash-resume
(``kill_at`` simulates a failure mid-run; the second call restores and
continues on the same data stream).  Runs on the card by default;
``--device cpu`` runs it on the CPU.

Run: PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.configs import smoke_config
from repro_torch.launch.train import train_loop
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = smoke_config(args.arch)
    shape = ShapeConfig("example", args.seq, args.batch, "train")
    tc = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=20,
                                   total_steps=args.steps))
    run = dict(steps=args.steps, tc=tc, ckpt_every=20, device=args.device)

    with tempfile.TemporaryDirectory() as ckpt:
        crash_at = args.steps // 2
        print(f"=== phase 1: train to step {crash_at}, then 'crash' ===")
        _, losses1 = train_loop(cfg, shape, ckpt_dir=ckpt,
                                hb_dir=ckpt + "/hb", kill_at=crash_at, **run)
        print("\n=== phase 2: restart from checkpoint ===")
        _, losses2 = train_loop(cfg, shape, ckpt_dir=ckpt,
                                hb_dir=ckpt + "/hb", **run)
        print(f"\nloss: start {losses1[0]:.3f} -> "
              f"pre-crash {losses1[-1]:.3f} -> final {losses2[-1]:.3f}")
        if not losses2[-1] < losses1[0]:
            raise SystemExit("loss did not decrease")


if __name__ == "__main__":
    main()
