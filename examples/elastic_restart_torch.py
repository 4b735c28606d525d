"""Fault-tolerance walkthrough on the PyTorch/CUDA port: heartbeats ->
supervisor detects a dead host -> plans an elastic re-mesh -> training
restarts from the latest checkpoint.

The port's counterpart of ``examples/elastic_restart.py``.  Everything
is simulated with files on one machine, through the port's ``ft`` and
``checkpoint``; one card holds the whole state, so the restart restores
whole tensors (the reader also assembles chunks a sharded mesh wrote).
Runs on the card by default; ``--device cpu`` runs it on the CPU.

Run: PYTHONPATH=src python examples/elastic_restart_torch.py [--device cpu]
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.configs import smoke_config
from repro_torch.ft import Heartbeat, Supervisor
from repro_torch.launch.train import train_loop
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = smoke_config("gemma-2b")
    shape = ShapeConfig("demo", 64, 4, "train")
    tc = TrainConfig(opt=OptConfig(lr=2e-3, warmup_steps=10,
                                   total_steps=60))
    hosts = [f"host{i}" for i in range(4)]

    with tempfile.TemporaryDirectory() as root:
        hb_dir, ckpt = root + "/hb", root + "/ckpt"
        run = dict(tc=tc, ckpt_dir=ckpt, ckpt_every=10, hb_dir=hb_dir,
                   host="host0", log_every=10, device=args.device)
        print("=== 4-host fleet trains; host0 runs the real loop ===")
        _, losses1 = train_loop(cfg, shape, steps=30, kill_at=25, **run)
        # other hosts heartbeat in lockstep (simulated)
        for h in hosts[1:3]:
            Heartbeat(hb_dir, h).beat(25, 0.5)
        # host3 died silently: it never wrote a heartbeat

        sup = Supervisor(hb_dir, hosts, chips_per_host=64,
                         model_parallel=16, timeout_s=3600)
        action = sup.poll()
        print(f"\nsupervisor: dead={action['dead']} -> "
              f"action={action['action']}, new mesh "
              f"(pods, data, model) = {action['new_mesh']}")
        if action["action"] != "remesh":
            raise SystemExit(f"expected a remesh, got {action}")

        print("\n=== restart on the shrunken fleet from the last "
              "checkpoint ===")
        _, losses = train_loop(cfg, shape, steps=60, **run)
        print(f"\nresumed and finished; loss {losses1[0]:.3f} -> final "
              f"{losses[-1]:.3f}")
        if not losses[-1] < losses1[0]:
            raise SystemExit("loss did not decrease")


if __name__ == "__main__":
    main()
