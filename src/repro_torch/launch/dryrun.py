"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on
meta tensors over a fake process group.

The reference lowers and compiles each cell with XLA on 512 placeholder
CPU devices and reads the HLO.  The port has no compiler to ask, so
``build`` runs the step itself: the state, batch and caches are meta
tensors (shapes and dtypes, no data) wrapped in DTensors laid out by
the port's specs over the cell's mesh.  The production meshes are
``init_device_mesh`` over ``world_size`` fake ranks (``fake_world``, the
counterpart of ``--xla_force_host_platform_device_count=512``): this
process is rank 0, collectives move nothing, and every figure is rank
0's, i.e. per device.

Meta tensors rather than ``FakeTensorMode``: under a fake mode DTensor
takes every op for a traced graph and recomputes its sharding strategy
on each call, uncached (a smoke twin's train step took 24 s each time
against 16 s once and 0.4 s after under meta tensors), and a
``_StridedShard``'s offsets are computed with a tensor op that a fake
mode refuses.  Data-dependent ops fail on meta tensors as they would on
fake ones.

Per cell this produces (written to experiments/dryrun_torch/<cell>.json):
  * proof that the step runs on the cell's mesh: every op has a DTensor
    sharding strategy or the cell ends in ``error`` naming the op
    (DTensor raises; nothing falls back);
  * memory: ``torch.distributed._tools.MemTracker``'s per-device peak
    over the step, split into the arguments (state, batch, caches: their
    local shards) and the rest (DTensor's global-shape shape inference
    hidden from it: ``cost.no_shadow_ops``);
  * per-device flops (matmul), elementwise work, bytes and collective
    bytes from ``repro_torch.launch.cost`` — its roofline inputs.

DTensor chooses its own layouts where GSPMD would choose others (it may
leave a weight gradient ``Partial`` and all-reduce it later), so the
port's collective bytes are not expected to equal XLA's.  The roofline
constants are an H100 SXM5's data-sheet values (``roofline_terms``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed._tools import MemTracker
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (ARCH_NAMES, batch_specs, decode_specs,
                                 get_config)
from repro_torch.distributed.ctx import act_rules
from repro_torch.distributed.sharding import (batch_pspecs, cache_pspecs,
                                              distribute_tree, state_pspecs)
from repro_torch.launch.cost import CostMode, no_shadow_ops
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import model_schema
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.models.schema import (abstract_params, logical_spec,
                                       make_rules, param_count, pspecs)
from repro_torch.optim import OptConfig
from repro_torch.quant.storage import QuantizedTensor
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.step import (TrainConfig, abstract_state,
                                    make_train_step)

# Per-arch runtime knobs for the production cells.  n_micro keeps the
# activation working set inside HBM; sequence parallelism is on by
# default (see distributed.ctx); bf16 moments/grads are the only way
# 300B+ parameter Adam states fit a 256-chip pod at all.
RUNTIME: dict[str, dict] = {
    "grok-1-314b": dict(n_micro=8, moment_dtype="bfloat16",
                        grad_dtype="bfloat16"),
    "llama3-405b": dict(n_micro=8, moment_dtype="bfloat16",
                        grad_dtype="bfloat16"),
    "internvl2-26b": dict(n_micro=8),
    "jamba-v0.1-52b": dict(n_micro=8),
    "olmoe-1b-7b": dict(n_micro=4),
    "gemma-2b": dict(n_micro=4),
    "qwen3-4b": dict(n_micro=4),
    "qwen2-0.5b": dict(n_micro=2),
    "mamba2-2.7b": dict(n_micro=8),
    "seamless-m4t-medium": dict(n_micro=2),
}

# NVIDIA H100 SXM5 data sheet (dense, 700 W).  Matmul FLOP/s a card by
# the type a product runs in (``cost.Cost.flops_by_dtype``): the tensor
# cores' bf16/fp16, fp8 and TF32 rates, and float32 outside them.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12, "float8_e4m3fn": 1979e12,
              "float8_e5m2": 1979e12}
HBM_BW = 3.35e12         # HBM3 bytes/s a card
NVLINK_BW = 450e9        # NVLink bytes/s a direction, within an 8-card node
NET_BW = 50e9            # bytes/s a card across nodes (400 Gb/s NDR)
NODE_CARDS = 8

MESH_RANKS = {"single": 256, "multi": 512}


def _local_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, QuantizedTensor):
        return _local_bytes(tree.data) + _local_bytes(tree.scale)
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, QuantizedTensor):
        return [tree.data, tree.scale]
    return [tree]


def _world(n: int) -> None:
    """Make the default group ``n`` fake ranks (a fresh one when its size
    differs)."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    fake_world(n)


def _axis_ranks(mesh, i: int) -> list:
    """The ranks of rank 0's group along mesh dim ``i``."""
    idx = [0] * mesh.ndim
    idx[i] = slice(None)
    return mesh.mesh[tuple(idx)].flatten().tolist()


def axis_links(mesh) -> dict:
    """{mesh axis: "nvlink" | "network"}: whether rank 0's group along
    the axis stays inside one node of ``NODE_CARDS`` consecutive ranks."""
    return {name: ("nvlink" if len({r // NODE_CARDS for r in
                                     _axis_ranks(mesh, i)}) == 1
                   else "network")
            for i, name in enumerate(mesh.mesh_dim_names)}


def _axis_of(mesh, group_name: str) -> str:
    """The mesh axis whose ranks a collective's process group holds (a
    mesh built again in one process gets new groups of the same
    ranks, and DTensor may run on either)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    ranks = sorted(dist.get_process_group_ranks(
        _resolve_process_group(group_name)))
    for i, name in enumerate(mesh.mesh_dim_names):
        if sorted(_axis_ranks(mesh, i)) == ranks:
            return name
    return group_name


def build(arch: str, shape_name: str, mesh_kind: str,
          overrides: dict | None = None, mesh=None) -> dict:
    """Trace one cell's step; returns its record (without status).
    ``shape_name`` names a shape of ``SHAPES`` or is a ``ShapeConfig``;
    ``mesh`` replaces the production mesh of ``mesh_kind`` (which then
    only labels the record)."""
    overrides = overrides or {}
    cfg = get_config(arch)
    if overrides.get("cfg_replace"):
        cfg = dataclasses.replace(cfg, **overrides["cfg_replace"])
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    shape_name = shape.name
    if mesh is None:
        _world(MESH_RANKS[mesh_kind])
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type="cpu")
    rt = dict(RUNTIME.get(arch, {}))
    rt.update(overrides)
    rules = make_rules(mesh, seq_parallel=rt.get("seq_parallel", True))
    schema = model_schema(cfg)
    info = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "kind": shape.kind, "params": param_count(schema),
            "n_devices": mesh.size(),
            "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "runtime": {k: v for k, v in rt.items() if not callable(v)}}

    if shape.kind == "train":
        # Each rank splits its own rows into micro-batches.
        n_micro = int(rt.get("n_micro", 1))
        entry = logical_spec(rules, "batch", dims=(shape.global_batch,))[0]
        split = math.prod(rules.sizes[a] for a in (
            () if entry is None else (entry,) if isinstance(entry, str)
            else entry))
        while (shape.global_batch // split) % n_micro:
            n_micro //= 2
        tc = TrainConfig(
            opt=OptConfig(moment_dtype=rt.get("moment_dtype", "float32")),
            n_micro=n_micro, grad_dtype=rt.get("grad_dtype", "float32"))
        info["runtime"]["n_micro"] = n_micro
        step = make_train_step(cfg, tc)
        batch = batch_specs(cfg, shape, train=True)
        args = (distribute_tree(abstract_state(cfg, tc), mesh,
                            state_pspecs(schema, rules)),
                distribute_tree(batch, mesh, batch_pspecs(batch, rules)))
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, max_len=shape.seq_len + cfg.num_prefix)
        batch = batch_specs(cfg, shape, train=False)
        args = (distribute_tree(abstract_params(schema, dtype=torch.bfloat16),
                            mesh, pspecs(schema, rules)),
                distribute_tree(batch, mesh, batch_pspecs(batch, rules)))
    else:  # decode
        params = abstract_params(schema, dtype=torch.bfloat16)
        pspec = pspecs(schema, rules)
        deq = None
        if rt.get("quant"):
            # HOBFLOPS bitplane weights: the paper's technique as the
            # decode memory-bandwidth lever.
            from repro_torch.quant.apply import (abstract_quantize_params,
                                                 make_deq, quantized_pspecs)
            params = abstract_quantize_params(params, cfg, rt["quant"])
            pspec = quantized_pspecs(pspec, params)
            deq = make_deq()
        serve = make_decode_step(cfg, deq=deq)
        specs = decode_specs(cfg, shape)
        tok_spec = logical_spec(rules, "batch", dims=(shape.global_batch,))
        # The port's decode takes the cache position as a Python int: the
        # last slot, where the reference's traced position may reach.
        pos = shape.seq_len + cfg.num_prefix - 1
        args = (distribute_tree(params, mesh, pspec),
                distribute_tree(specs["token"], mesh, tok_spec), pos,
                distribute_tree(specs["cache"], mesh,
                            cache_pspecs(specs["cache"], rules)))
        step = serve

    arg_bytes = _local_bytes({str(i): a for i, a in enumerate(args)
                              if not isinstance(a, int)})
    mt = MemTracker()
    mt.track_external(*[t for a in args if not isinstance(a, int)
                        for t in _leaves(a)])
    t0 = time.perf_counter()
    with (no_shadow_ops(), act_rules(rules), implicit_replication(), mt,
          CostMode() as cm):
        step(*args)
    trace_s = time.perf_counter() - t0
    peak = max((snap.get("Total", 0) for snap in
                mt.get_tracker_snapshot("peak").values()), default=0)
    cost = cm.cost.as_dict()
    cost["coll_by_axis"] = {}
    for g, b in cost.pop("coll_by_group").items():
        ax = _axis_of(mesh, g)
        cost["coll_by_axis"][ax] = cost["coll_by_axis"].get(ax, 0) + b
    info.update(trace_s=round(trace_s, 1), cost=cost,
                memory={"peak_bytes": peak, "argument_bytes": arg_bytes,
                        "rest_bytes": peak - arg_bytes},
                links=axis_links(mesh))
    return info


def dense_train_flops(cfg, batch: int, seq: int) -> dict:
    """Matmul FLOPs of one train step of a dense decoder as the port
    computes it, by term: ``dense`` = 6 T N_mm (T tokens; N_mm the
    projection weights and the logits head, the embedding gather being
    no matmul), ``attention`` = 12 L S^2 (H dh) B (full S x S scores,
    forward and backward), and ``remat``: each layer's forward run again
    in the backward pass, up to its last tensor that the backward needs
    (all but the MLP's down projection, whose output nothing saves)."""
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: a dense decoder's count only")
    d, L, T = cfg.d_model, cfg.n_layers, batch * seq
    q = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    layer = d * q + 2 * d * kv + q * d + 3 * d * cfg.d_ff
    attn_fwd = 4 * L * seq * seq * q * batch
    return {"dense": 6 * T * (L * layer + d * cfg.vocab_padded),
            "attention": 3 * attn_fwd,
            "remat": 2 * T * L * (layer - cfg.d_ff * d) + attn_fwd}


def roofline_terms(cost: dict, links: dict) -> dict:
    """Seconds per step, per card, for the three roofline terms, from an
    H100 SXM5's data-sheet rates: each type's matmul FLOPs at its own
    peak (``PEAK_FLOPS``: bf16 989 TFLOP/s, TF32 495, float32 67), HBM3
    3.35 TB/s, NVLink 450 GB/s a direction for an axis whose group stays
    inside one 8-card node, 50 GB/s a card (400 Gb/s NDR) for an axis
    that crosses nodes (``links``)."""
    t_c = sum(f / PEAK_FLOPS[k] for k, f in cost["flops_by_dtype"].items())
    t_m = cost["bytes"] / HBM_BW
    t_l = sum(b / (NVLINK_BW if links.get(ax) == "nvlink" else NET_BW)
              for ax, b in cost["coll_by_axis"].items())
    dom = max((t_c, "compute"), (t_m, "memory"), (t_l, "collective"))
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_l,
            "dominant": dom[1],
            "step_s_max": max(t_c, t_m, t_l),
            "step_s_sum": t_c + t_m + t_l}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             overrides: dict | None = None, tag: str = "",
             mesh=None) -> dict:
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    shape_name = shape.name
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fname = out / f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
    cfg = get_config(arch)
    okay, reason = shape_applicable(cfg, shape)
    if not okay:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skip", "reason": reason}
        fname.write_text(json.dumps(rec, indent=1))
        print(f"SKIP  {arch} {shape_name} {mesh_kind}: {reason}",
              flush=True)
        return rec

    t0 = time.time()
    try:
        rec = build(arch, shape, mesh_kind, overrides, mesh=mesh)
        rec.update(status="ok", wall_s=round(time.time() - t0, 1),
                   roofline=roofline_terms(rec["cost"], rec["links"]))
    except Exception as e:  # record the failure; the matrix keeps going
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "wall_s": round(time.time() - t0, 1),
               "traceback": traceback.format_exc()[-4000:]}
    fname.write_text(json.dumps(rec, indent=1))
    status = rec["status"]
    if status == "ok":
        r = rec["roofline"]
        extra = (f"trace={rec['trace_s']}s dom={r['dominant']} "
                 f"step={r['step_s_max']:.4f}s "
                 f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB")
    else:
        extra = rec.get("error", "")[:200]
    print(f"{status.upper():5s} {arch} {shape_name} {mesh_kind} {extra}",
          flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()

    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                run_cell(arch, shape, mesh_kind, args.out)


if __name__ == "__main__":
    main()
