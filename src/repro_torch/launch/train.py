"""Training launcher: data -> step -> metrics -> checkpoint -> heartbeat.

Runs on the card by default (``--device cpu`` runs the smoke configs on
the CPU), or over a ``DeviceMesh`` (``mesh=``): the state and each batch
are DTensors laid out by the port's sharding rules, and the model's
activation anchors follow the same rules.  Restart-safe by construction:
on start it restores the newest complete checkpoint (if any) and the
synthetic data pipeline replays from the restored step.  ``--kill-at``
simulates a mid-run crash for the fault-tolerance tests and examples.

    PYTHONPATH=src python -m repro_torch.launch.train --full --arch qwen2-0.5b
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch._build import resolve_device, synchronize
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import dataset_for, make_batch, place_batch
from repro_torch.distributed.ctx import act_rules
from repro_torch.distributed.sharding import (batch_pspecs, distribute_tree,
                                              state_pspecs)
from repro_torch.ft import Heartbeat, StragglerMonitor
from repro_torch.models import model_schema
from repro_torch.models.config import ShapeConfig
from repro_torch.models.schema import make_rules
from repro_torch.optim import OptConfig
from repro_torch.train.step import (TrainConfig, abstract_state, init_state,
                                    make_train_step, mesh_rows)


def _value(t) -> float:
    """A 0-d metric as a Python float (a DTensor's reduced first)."""
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def train_loop(cfg, shape, *, steps: int, tc: TrainConfig | None = None,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               hb_dir: str | None = None, host: str = "host0",
               device="cuda", mesh=None, seed: int = 0,
               kill_at: int | None = None, log_every: int = 10,
               print_fn=print, stats: dict | None = None):
    """Returns (final_state, losses).

    Parameters are drawn by ``init_params`` from a generator on
    ``device`` seeded with ``seed``; batch ``step`` is
    ``make_batch(dataset_for(cfg, shape, seed), step)``.  With a
    ``mesh`` (which sets the device: its type, this rank's card) every
    rank draws the same state and batch and keeps its shards
    (``state_pspecs``, ``batch_pspecs``); the step runs under
    ``act_rules(make_rules(mesh))``, plain tensors made inside it
    (positions, masks) taken as replicated.  Checkpoints hold whole
    tensors, written by rank 0, and a restore is redistributed.  Every
    ``ckpt_every`` steps the state is saved (async file IO), and once
    more at the end unless the last step was just saved.  ``stats``,
    when given, receives a step's milliseconds split into the host's
    batch (``make_batch`` and ``place_batch``) and the train step
    (through its loss read back), each step's gradient norm, every
    save's ``last_save`` record, the restore's seconds and the restored
    step."""
    if mesh is not None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else mesh.device_type)
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = tc or TrainConfig(opt=OptConfig(warmup_steps=20,
                                         total_steps=steps))
    ds = dataset_for(cfg, shape, seed)
    mgr = (CheckpointManager(ckpt_dir, writer=mesh is None
                             or dist.get_rank() == 0)
           if ckpt_dir else None)
    hb = Heartbeat(hb_dir, host) if hb_dir else None
    mon = StragglerMonitor()
    out = {} if stats is None else stats
    out.update(batch_ms=[], step_ms=[], grad_norm=[], saves=[])

    rules = None if mesh is None else make_rules(mesh)
    sspecs = None if mesh is None else state_pspecs(model_schema(cfg), rules)

    def place(tree, specs):
        return tree if mesh is None else distribute_tree(tree, mesh, specs)

    def in_mesh():
        stack = contextlib.ExitStack()
        if mesh is not None:
            stack.enter_context(act_rules(rules))
            stack.enter_context(implicit_replication())
        return stack

    step_fn = make_train_step(cfg, tc)
    start, state = 0, None
    if mgr is not None:
        t0 = time.perf_counter()
        restored_step, restored = mgr.restore_latest(
            abstract_state(cfg, tc), device)
        if restored is not None:
            synchronize(device)
            out.update(restore_s=time.perf_counter() - t0,
                       restored_step=restored_step)
            state, start = place(restored, sspecs), restored_step + 1
            print_fn(f"[train] restored checkpoint step "
                     f"{restored_step}; resuming at {start}")
    if state is None:
        state = place(init_state(
            cfg, tc, torch.Generator(device=device).manual_seed(seed),
            device), sspecs)

    def save(step, block=False):
        mgr.save(step, state, block=block)
        out["saves"].append(mgr.last_save)

    losses = []
    saved_at = None
    for step in range(start, steps):
        t0 = time.time()
        batch = place_batch(make_batch(ds, step), device)
        if mesh is not None:
            batch = mesh_rows(batch, tc.n_micro, rules)
            batch = place(batch, batch_pspecs(batch, rules))
        t1 = time.time()
        with in_mesh():
            state, metrics = step_fn(state, batch)
        loss = _value(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        out["batch_ms"].append((t1 - t0) * 1e3)
        out["step_ms"].append((dt - (t1 - t0)) * 1e3)
        out["grad_norm"].append(_value(metrics["grad_norm"]))
        mon.observe(host, dt)
        if hb is not None:
            hb.beat(step, dt)
        if step % log_every == 0 or step == steps - 1:
            print_fn(f"[train] step {step:5d} loss {loss:.4f} "
                     f"gnorm {out['grad_norm'][-1]:.3f} "
                     f"lr {_value(metrics['lr']):.2e} {dt:.2f}s")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            save(step)
            saved_at = step
        if kill_at is not None and step >= kill_at:
            print_fn(f"[train] simulated crash at step {step}")
            if mgr is not None:
                mgr.wait()
            return state, losses
    if mgr is not None:
        if saved_at != steps - 1:
            save(steps - 1, block=True)
        mgr.wait()
    return state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--hb-dir", default=None)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    train_loop(cfg, shape, steps=args.steps, ckpt_dir=args.ckpt_dir,
               hb_dir=args.hb_dir, kill_at=args.kill_at, device=args.device)


if __name__ == "__main__":
    main()
