"""The port's distribution and launch layer against the JAX package:
sharding rules and specs, input specs, abstract quantization, int8
gradient compression, the dispatch cost counter and the meta-tensor dry
run; and the conv quickstart on the CPU.

Spec checks are pure Python on both sides (no jit): the reference's
``pspecs`` / ``logical_spec`` / ``batch_pspecs`` / ``cache_pspecs`` on
the fake meshes of ``tests/test_sharding.py`` against the port's, as
tuples, exactly.  One module fixture (``worlds``) holds this process's
fake process group and resizes it (4 ranks for the (2, 2) mesh, 256 for
the production mesh); one more fixture runs a real 2-rank gloo group in
two spawned processes over a ``FileStore``, started when the module's
first test runs: a compressed psum, sharded cache rows, two train
steps of a dense, a MoE and a Mamba-2 smoke twin held to the one-device
steps, and checkpoints carried both ways between
the mesh run and the one-device run, bit for bit.

Tolerances: compression without a generator is bit-exact against the
reference; two 2-rank train steps against the one-device steps are held
to ``tests/test_torch_train.py``'s train-step tolerances at float32
compute: losses and gradient norms 1e-5 relative, the AdamW moments
1e-3 relative with ``1e-4 * max`` absolute, parameters the sum of the
two steps' ``2 * lr_at(opt, s)`` absolute.
"""
import dataclasses
import math
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_NAMES
from repro.configs import batch_specs as jbatch_specs
from repro.configs import cache_specs as jcache_specs
from repro.configs import decode_specs as jdecode_specs
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jshard
from repro.models import model_schema as jmodel_schema
from repro.models import schema as jschema
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import shape_applicable
from repro.quant import apply as japply
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import abstract_state as jabstract_state
from repro_torch import configs as tconfigs
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tshard
from repro_torch.launch import cost as tcost
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import model_schema as tmodel_schema
from repro_torch.models import schema as tschema
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.quant import apply as tapply
from repro_torch.quant.storage import QuantizedTensor as TQ

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESHES = {"pod": dict(pod=2, data=16, model=16),
          "nopod": dict(pod=0, data=16, model=16)}
METRIC_TOL = 1e-5


def fake_mesh(pod, data, model):
    """The reference test's stand-in mesh: ``axis_names`` and
    ``devices.shape``, which both packages' ``make_rules`` read."""
    sizes = {"pod": pod, "data": data, "model": model}
    axes = [a for a, s in sizes.items() if s]

    class M:
        axis_names = tuple(axes)

        class devices:
            shape = tuple(sizes[a] for a in axes)
    return M


def rules(mesh_kind, sp=True):
    m = fake_mesh(**MESHES[mesh_kind])
    return (jschema.make_rules(m, seq_parallel=sp),
            tschema.make_rules(m, seq_parallel=sp))


def jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def tleaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tleaves(tree[k])]
    return [tree]


def same_specs(jtree, ttree):
    """Same structure and, leaf by leaf, the same entries."""
    assert jax.tree.structure(jtree, is_leaf=lambda x: isinstance(x, JP)) \
        == jax.tree.structure(ttree, is_leaf=lambda x: isinstance(
            x, tschema.PartitionSpec))
    for a, b in zip(jleaves(jtree), tleaves(ttree)):
        assert isinstance(b, tschema.PartitionSpec)
        assert tuple(a) == tuple(b), (a, b)


def same_shapes(jtree, ttree):
    """Same leaf names, shapes and dtypes (meta tensors on the port's
    side, ShapeDtypeStructs on the reference's)."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = [(k, v) for k, v in _paths(ttree)]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [k for k, _ in tl]
    for (_, a), (name, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(np.dtype(a.dtype)) == str(b.dtype).removeprefix(
            "torch."), name
        assert b.device.type == "meta", name


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        f"{prefix}['{k}']")]
    return [(prefix, tree)]


# ---------------------------------------------------------------------------
# (a) sharding rules and specs, exactly as the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspecs_match_reference(arch):
    for mesh_kind in MESHES:
        for sp in (True, False):
            jr, tr = rules(mesh_kind, sp)
            same_specs(jschema.pspecs(jmodel_schema(jget_config(arch)), jr),
                       tschema.pspecs(tmodel_schema(
                           tconfigs.get_config(arch)), tr))
            same_specs(jshard.state_pspecs(jmodel_schema(jget_config(arch)),
                                           jr),
                       tshard.state_pspecs(tmodel_schema(
                           tconfigs.get_config(arch)), tr))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_pspecs_match_reference(arch):
    jcfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    for mesh_kind in MESHES:
        jr, tr = rules(mesh_kind)
        for name, shape in SHAPES.items():
            if not shape_applicable(jcfg, JSHAPES[name])[0]:
                continue
            for train in (True, False):
                same_specs(
                    jshard.batch_pspecs(jbatch_specs(jcfg, JSHAPES[name],
                                                     train=train), jr),
                    tshard.batch_pspecs(tconfigs.batch_specs(
                        tcfg, shape, train=train), tr))
            if shape.kind == "decode":
                same_specs(jshard.cache_pspecs(jcache_specs(
                               jcfg, JSHAPES[name]), jr),
                           tshard.cache_pspecs(tconfigs.cache_specs(
                               tcfg, shape), tr))


@pytest.mark.parametrize("axes,dims", [
    (("batch", None, "qheads", None), (128, 4096, 14, 64)),
    (("batch", None, "qheads", None), (128, 4096, 128, 64)),
    (("layers", "batch", "kvseq", "kvheads", None), (32, 1, 524288, 8, 128)),
    (("layers", "batch", "kvseq", "kvheads", None),
     (32, 128, 32768, 8, 128)),
    (("batch", "act_seq", None), (8, 4096, 896)),
    (("batch", "act_seq", None), (8, 1, 896)),
    (("batch", "experts", None, None), (4, 64, 80, 2048)),
    (("batch", None, "vocab"), (8, 4096, 152064)),
])
def test_logical_spec_matches_reference(axes, dims):
    for mesh_kind in MESHES:
        for sp in (True, False):
            jr, tr = rules(mesh_kind, sp)
            for d in (dims, None):
                assert tuple(jschema.logical_spec(jr, *axes, dims=d)) == \
                    tuple(tschema.logical_spec(tr, *axes, dims=d))


def test_named_placements_follow_mesh_order(worlds):
    from torch.distributed.tensor import Replicate, Shard
    mesh = worlds(4)
    P = tschema.PartitionSpec
    assert tshard.placements(mesh, P(None, ("data", "model"))) == (
        Shard(1), Shard(1))
    assert tshard.placements(mesh, P("model", "data")) == (Shard(1),
                                                          Shard(0))
    assert tshard.placements(mesh, P(None, None)) == (Replicate(),
                                                      Replicate())
    with pytest.raises(ValueError, match="out of mesh order"):
        tshard.placements(mesh, P(("model", "data"),))


# ---------------------------------------------------------------------------
# (b) input specs and abstract quantization: the reference's shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_reference(arch):
    jcfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    for name, shape in SHAPES.items():
        if not shape_applicable(jcfg, JSHAPES[name])[0]:
            continue
        for mode in ("train", "prefill"):
            same_shapes(jinput_specs(jcfg, JSHAPES[name], mode),
                        tconfigs.input_specs(tcfg, shape, mode))
        if shape.kind == "decode":
            same_shapes(jdecode_specs(jcfg, JSHAPES[name]),
                        tconfigs.decode_specs(tcfg, shape))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_abstract_quantize_matches_reference(arch):
    jcfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    jq = japply.abstract_quantize_params(
        jschema.abstract_params(jmodel_schema(jcfg)), jcfg, "hobflops9")
    tq = tapply.abstract_quantize_params(
        tschema.abstract_params(tmodel_schema(tcfg)), tcfg, "hobflops9")
    jr, tr = rules("pod")
    js = japply.quantized_pspecs(jschema.pspecs(jmodel_schema(jcfg), jr), jq)
    ts = tapply.quantized_pspecs(tschema.pspecs(tmodel_schema(tcfg), tr), tq)
    n = 0

    def walk(j, t, jsp, tsp):
        nonlocal n
        if isinstance(t, dict):
            assert sorted(j) == sorted(t)
            for k in t:
                walk(j[k], t[k], jsp[k], tsp[k])
            return
        if isinstance(t, TQ):
            n += 1
            for f in ("data", "scale"):
                a, b = getattr(j, f), getattr(t, f)
                assert tuple(a.shape) == tuple(b.shape)
                assert str(np.dtype(a.dtype)) == str(b.dtype)[6:]
                assert b.device.type == "meta"
                assert tuple(getattr(jsp, f)) == tuple(getattr(tsp, f))
            assert (j.layout, tuple(j.shape)) == (t.layout, tuple(t.shape))
            assert (j.sfmt.w_e, j.sfmt.w_f) == (t.sfmt.w_e, t.sfmt.w_f)
            return
        assert tuple(j.shape) == tuple(t.shape)
        assert tuple(jsp) == tuple(tsp)
    walk(jq, tq, js, ts)
    assert n > 0


# ---------------------------------------------------------------------------
# Fake process groups (one default group a process: resized in place)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def worlds():
    """``worlds(n)`` makes the default group ``n`` fake ranks and
    returns a (2, 2) ``("data", "model")`` mesh for 4 ranks, (16, 16)
    for 256; the group is destroyed when the module ends."""
    def get(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        fake_world(n)
        shape = {4: (2, 2), 256: (16, 16)}[n]
        return make_mesh(shape, ("data", "model"), device_type="cpu")
    yield get
    if dist.is_initialized():
        dist.destroy_process_group()


def _local_bytes(tree):
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in tleaves(tree))


@pytest.mark.parametrize("arch", ["grok-1-314b", "qwen2-0.5b"])
def test_state_bytes_per_device_match_reference_specs(worlds, arch):
    """(c) The state distributed by the port's specs on a fake (16, 16)
    mesh holds, per device, the bytes that the reference's specs
    imply."""
    mesh = worlds(256)
    rt = tdry.RUNTIME[arch]
    jcfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    sizes = {"data": 16, "model": 16}
    jstate = jabstract_state(jcfg, JTrainConfig(
        opt=dataclasses.replace(JTrainConfig().opt,
                                moment_dtype=rt.get("moment_dtype",
                                                    "float32"))))
    jspec = jshard.state_pspecs(jmodel_schema(jcfg),
                                jschema.make_rules(fake_mesh(0, 16, 16)))
    want = 0
    for leaf, spec in zip(jax.tree.leaves(jstate), jleaves(jspec)):
        local = [dim // math.prod(sizes[a] for a in (
                     () if e is None else (e,) if isinstance(e, str) else e))
                 for dim, e in zip(leaf.shape, tuple(spec) + (None,) * (
                     len(leaf.shape) - len(spec)))]
        want += math.prod(local) * np.dtype(leaf.dtype).itemsize
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, abstract_state
    tstate = abstract_state(tcfg, TrainConfig(opt=OptConfig(
        moment_dtype=rt.get("moment_dtype", "float32"))))
    dstate = tshard.distribute_tree(tstate, mesh, tshard.state_pspecs(
        tmodel_schema(tcfg), tschema.make_rules(mesh)))
    assert _local_bytes(dstate) == want


# ---------------------------------------------------------------------------
# (d) int8 gradient compression: bit-exact without randomness
# ---------------------------------------------------------------------------
def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_quantize_int8_matches_reference():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal(4096).astype(np.float32) * 3e-3,
              rng.standard_normal((64, 96)).astype(np.float32),
              np.zeros(16, np.float32)):
        jc, js = jcomp.quantize_int8(jnp.asarray(x))
        tc, ts = tcomp.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        assert _bits(js) == _bits(ts.numpy())
        np.testing.assert_array_equal(
            _bits(jcomp.dequantize_int8(jc, js)),
            _bits(tcomp.dequantize_int8(tc, ts).numpy()))


def test_compress_grads_rounds_match_reference():
    rng = np.random.default_rng(1)
    shapes = {"a": (32, 48), "b": {"c": (100,), "d": (3, 5, 7)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.standard_normal(s) * 1e-2).astype(np.float32)
    jef = jcomp.make_error_feedback(jax.tree.map(jnp.asarray, draw(shapes)))
    tef = tcomp.make_error_feedback(tschema._map(torch.from_numpy,
                                                 draw(shapes)))
    for _ in range(20):
        g = draw(shapes)
        jout, jef = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), jef)
        tout, tef = tcomp.compress_grads(tschema._map(torch.from_numpy, g),
                                         tef)
        for a, b in zip(jax.tree.leaves(jout), tleaves(tout)):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
        for a, b in zip(jax.tree.leaves(jef), tleaves(tef)):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    jg = {"a": jnp.zeros((128, 128)), "b": jnp.zeros(64)}
    tg = {"a": torch.zeros(128, 128), "b": torch.zeros(64)}
    for c in (True, False):
        assert jcomp.wire_bytes(jg, c) == tcomp.wire_bytes(tg, c)


def test_stochastic_rounding_unbiased():
    """With amax 1, 0.3 sits at code 38.1: nearest rounding sends every
    copy to 38 (-7.9e-4 each); stochastic rounding is right on average
    (its mean's spread over 20000 copies is ~2e-5)."""
    x = torch.cat([torch.ones(1), torch.full((20000,), 0.3)])
    for gen, lo, hi in ((torch.Generator().manual_seed(0), 0, 1e-4),
                        (None, 7e-4, 9e-4)):
        codes, scale = tcomp.quantize_int8(x, generator=gen)
        bias = abs(float(tcomp.dequantize_int8(codes, scale)[1:].mean())
                   - 0.3)
        assert lo <= bias < hi, (gen, bias)


# ---------------------------------------------------------------------------
# (e) a real 2-rank gloo group in two spawned processes
# ---------------------------------------------------------------------------
def _gloo_rank(rank, store_path, ckpt, q):
    """One rank of the 2-rank ``(data=2, model=1)`` CPU mesh: the
    compressed psum, the row writes of a sharded cache, two float32
    train steps of each ``TWINS`` smoke twin (the first checkpointing
    into ``ckpt/mesh``), and a restore of the device run's checkpoint in
    ``ckpt/device``.  Puts (rank, results) on ``q``."""
    torch.set_num_threads(1)
    from repro_torch.distributed.ctx import write_rows
    from repro_torch.launch.train import train_loop
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    try:
        mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
        x = torch.from_numpy(_psum_input(rank))
        psum = tcomp.compressed_psum(x, mesh.get_group("data")).numpy()
        rows = distribute_tensor(torch.zeros(4, 10), mesh,
                                 [Shard(1), Replicate()])
        write_rows(rows, torch.arange(12.0).reshape(4, 3), 3, 1)
        runs = {}
        for arch in TWINS:
            cfg, shape, tc = _train_case(arch)
            stats = {}
            state, losses = train_loop(
                cfg, shape, tc=tc, mesh=mesh, stats=stats,
                ckpt_dir=f"{ckpt}/mesh" if arch == TWINS[0] else None,
                **TRAIN_RUN)
            runs[arch] = _record(state, losses, stats, full=True)
        cfg, shape, tc = _train_case(TWINS[0])
        restored, _ = train_loop(cfg, shape, tc=tc, mesh=mesh,
                                 ckpt_dir=f"{ckpt}/device", **TRAIN_RUN)
        q.put((rank, {"psum": psum, "rows": rows.full_tensor().numpy(),
                      "runs": runs,
                      "restored": _record(restored, [], {"grad_norm": []},
                                          full=True)["params"]}))
    finally:
        dist.destroy_process_group()


def _psum_input(rank):
    return (np.random.default_rng(10 + rank).standard_normal(257)
            * (1 + rank)).astype(np.float32)


# A dense model, a MoE and a Mamba-2 model: the data=2 gradient exchange
# of plain DTensor ops, of the expert FFN's and of the SSD body's
# per-shard weights.
TWINS = ("qwen2-0.5b", "olmoe-1b-7b", "mamba2-2.7b")
TRAIN_RUN = dict(steps=2, print_fn=lambda m: None)


def _train_case(arch):
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig
    cfg = dataclasses.replace(tconfigs.smoke_config(arch),
                              compute_dtype="float32")
    tc = TrainConfig(opt=OptConfig(warmup_steps=2, total_steps=4),
                     n_micro=2)
    return cfg, ShapeConfig("gloo", 32, 4, "train"), tc


def _record(state, losses, stats, full=False):
    """A run's losses, gradient norms, and parameters and moments as
    numpy arrays in leaf order (a DTensor's gathered first)."""
    from repro_torch.models.schema import _leaves

    def arrays(tree):
        return [(p.full_tensor() if full else p).numpy()
                for p in _leaves(tree)]
    return {"losses": losses, "grad_norm": stats["grad_norm"],
            "params": arrays(state["params"]),
            "m": arrays(state["opt"]["m"]), "v": arrays(state["opt"]["v"])}


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Runs the one-device steps first (the first twin's checkpoint is
    the ranks' restore), then starts the ranks; ``result()`` waits for
    them and returns (their results, the one-device runs' records, the
    checkpoint directory)."""
    from repro_torch.launch.train import train_loop
    ckpt = tmp_path_factory.mktemp("ckpt")
    device = {}
    for arch in TWINS:
        cfg, shape, tc = _train_case(arch)
        stats = {}
        state, losses = train_loop(
            cfg, shape, tc=tc, device="cpu", stats=stats,
            ckpt_dir=str(ckpt / "device") if arch == TWINS[0] else None,
            **TRAIN_RUN)
        device[arch] = _record(state, losses, stats)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [ctx.Process(target=_gloo_rank, args=(r, store, str(ckpt), q))
             for r in range(2)]
    for p in procs:
        p.start()

    def result():
        got = dict(q.get(timeout=100) for _ in procs)
        for p in procs:
            p.join(timeout=15)
            assert not p.is_alive() and p.exitcode == 0
        return got, device, ckpt
    yield result
    for p in procs:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_gloo_early(gloo_runs):
    """Start the two ranks when the module's first test runs, so that
    they work while the other tests do."""


# ---------------------------------------------------------------------------
# (f) the dispatch cost counter
# ---------------------------------------------------------------------------
def test_cost_counts_matmuls_and_loops():
    meta = lambda *s: torch.empty(s, device="meta")       # noqa: E731
    a, w = meta(64, 128), meta(128, 256)
    with tcost.CostMode() as m:
        a @ w
    assert m.cost.flops == 2 * 64 * 128 * 256
    assert m.cost.bytes == 4 * (64 * 128 + 128 * 256 + 64 * 256)
    with tcost.CostMode() as m:
        torch.einsum("bij,bjk->bik", meta(4, 32, 64), meta(4, 64, 16))
    assert m.cost.flops == 2 * 4 * 32 * 64 * 16
    costs = {}
    for depth in (4, 8):
        ws = meta(depth, 128, 128)
        with tcost.CostMode() as m:
            c = meta(64, 128)
            for i in range(depth):
                c = torch.tanh(c @ ws[i])
        costs[depth] = m.cost
    for depth, c in costs.items():
        assert c.flops == depth * 2 * 64 * 128 * 128
        assert c.elem_flops == depth * 64 * 128
    assert costs[8].bytes == 2 * costs[4].bytes


def test_roofline_prices_flops_by_dtype(monkeypatch):
    """Each matmul's FLOPs at its type's peak: bf16, float32 outside the
    tensor cores, and TF32 when it is allowed."""
    mm = 2 * 64 * 128 * 256
    with tcost.CostMode() as m:
        for dt in (torch.bfloat16, torch.float32):
            torch.empty(64, 128, dtype=dt, device="meta") @ torch.empty(
                128, 256, dtype=dt, device="meta")
    assert m.cost.flops_by_dtype == {"bfloat16": mm, "float32": mm}
    terms = tdry.roofline_terms(
        dict(m.cost.as_dict(), coll_by_axis={}), {})
    assert terms["compute_s"] == mm / 989e12 + mm / 67e12
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with tcost.CostMode() as m:
        torch.empty(64, 128, device="meta") @ torch.empty(128, 256,
                                                          device="meta")
    assert m.cost.flops_by_dtype == {"tf32": mm}


def test_cost_counts_one_all_gather(worlds):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = worlds(4)
    d = distribute_tensor(torch.empty(1024, 8, device="meta"), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    with tcost.CostMode() as m:
        d.redistribute(mesh, [Replicate(), Replicate()])
    assert m.cost.coll_bytes == 512 * 8 * 4
    assert m.cost.coll_hist == {"all_gather_into_tensor": 512 * 8 * 4}
    assert m.cost.coll_by_group == {mesh.get_group(0).group_name: 16384}


def test_cost_counts_local_shards_only(worlds):
    """A DTensor op counts its local shards' work once: the op that
    DTensor runs again on global shapes to infer its output does not
    reach the counter."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = worlds(4)
    a = distribute_tensor(torch.empty(96, 128, device="meta"), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    w = distribute_tensor(torch.empty(128, 80, device="meta"), mesh,
                          [Replicate(), Shard(1)], src_data_rank=None)
    with tcost.CostMode() as m:
        a @ w
    assert m.cost.flops == 2 * 48 * 128 * 40
    assert m.cost.ops == 1


# ---------------------------------------------------------------------------
# (g) the dry run's cells on a fake (2, 2) mesh
# ---------------------------------------------------------------------------
@pytest.fixture
def strict_views(monkeypatch):
    """Views of DTensors as strict as on older torch (2.11, the card's):
    a view whose result would need a redistribution or a strided shard
    raises, where this torch keeps ``_StridedShard`` layouts."""
    from torch.distributed.tensor._ops import _view_ops
    from torch.distributed.tensor.placement_types import _StridedShard
    propagate = _view_ops.propagate_shape_and_sharding

    def strict(src, shape, rule, mesh_sizes, strict_view=False):
        tgt, out = propagate(src, shape, rule, mesh_sizes, strict_view)
        if strict_view and (tuple(tgt) != tuple(src) or any(
                isinstance(pl, _StridedShard) for pl in out)):
            raise RuntimeError(f"view needs a redistribution: {src} -> "
                               f"{tgt} ({out})")
        return tgt, out
    monkeypatch.setattr(_view_ops, "propagate_shape_and_sharding", strict)


# A dense model, a Mamba-2 model, and the hybrid (attention, Mamba-2 and
# MoE layers).
@pytest.mark.parametrize("arch", ["llama3-405b", "mamba2-2.7b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_cells_on_fake_mesh(worlds, tmp_path, strict_views, arch,
                                   kind):
    """A smoke twin's cells through ``run_cell`` (at 4 x 64 tokens: the
    sharding planner's cost grows with the sizes of split dims), with
    views held to older torch's rule."""
    mesh = worlds(4)
    cfg = tconfigs.smoke_config(arch)
    shape = ShapeConfig(f"smoke_{kind}", 64, 4, kind)
    rec = tdry.run_cell(arch, shape, "2x2", str(tmp_path),
                        overrides={"cfg_replace": dataclasses.asdict(cfg)},
                        mesh=mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert (tmp_path / f"{arch}__smoke_{kind}__2x2.json").exists()
    assert rec["n_devices"] == 4 and rec["cost"]["flops"] > 0
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_bytes"]
    assert set(rec["roofline"]) >= {"compute_s", "memory_s",
                                    "collective_s", "dominant"}
    if kind == "train":
        assert rec["cost"]["coll_bytes"] > 0
    if kind == "train" and cfg.family == "dense":
        # per device: at least a quarter of the whole step's matmuls (a
        # rank's share of each split op), at most all of them
        total = sum(tdry.dense_train_flops(cfg, 4, 64).values())
        assert total / 4 <= rec["cost"]["flops"] <= total


def test_dryrun_train_flops_equal_analytic_on_one_rank():
    """On a one-rank mesh every op is whole: the counted matmul FLOPs
    equal ``dense_train_flops``, remat's recompute included."""
    if dist.is_initialized():
        dist.destroy_process_group()
    fake_world(1)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = tconfigs.smoke_config("qwen2-0.5b")
        rec = tdry.build("qwen2-0.5b", ShapeConfig("t", 64, 4, "train"),
                         "host", {"cfg_replace": dataclasses.asdict(cfg)},
                         mesh=mesh)
        assert rec["cost"]["flops"] == sum(
            tdry.dense_train_flops(cfg, 4, 64).values())
        assert rec["cost"]["coll_bytes"] == 0
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (h) the conv quickstart, and the package boundary
# ---------------------------------------------------------------------------
@pytest.mark.timeout(45)
def test_quickstart_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "examples/quickstart_torch.py", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=40,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert "bit-exact vs oracle : True" in out.stdout


@pytest.mark.timeout(45)
def test_distribution_imports_load_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.distributed, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.cost, repro_torch.launch.mesh\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'repro')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=40,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# The ranks' results, read last: they ran while the tests above did.
@pytest.mark.timeout(120)
def test_two_rank_gloo_group(gloo_runs):
    got, device, ckpt = gloo_runs()
    xs = [_psum_input(r) for r in range(2)]
    amax = max(float(np.abs(x).max()) for x in xs)
    scale = np.float32(max(amax, 1e-12)) / np.float32(127.0)
    codes = [np.clip(np.round(x / scale), -127, 127).astype(np.int32)
             for x in xs]
    want = (codes[0] + codes[1]).astype(np.float32) * scale
    rows = np.zeros((4, 10), np.float32)
    rows[:, 3:6] = np.arange(12.0).reshape(4, 3)
    for r in range(2):
        np.testing.assert_array_equal(_bits(got[r]["psum"]), _bits(want))
        np.testing.assert_array_equal(got[r]["rows"], rows)
    # two data=2 steps against the one-device steps: the second loss
    # follows the first update
    from repro_torch.checkpoint.store import restore_checkpoint
    from repro_torch.models.schema import _leaves
    from repro_torch.optim.adamw import lr_at
    from repro_torch.train import abstract_state
    for arch in TWINS:
        cfg, shape, tc = _train_case(arch)
        want = device[arch]
        tol = 2 * sum(float(lr_at(tc.opt, s))
                      for s in range(TRAIN_RUN["steps"]))
        for r in range(2):
            run = got[r]["runs"][arch]
            for k in ("losses", "grad_norm"):
                np.testing.assert_allclose(run[k], want[k], rtol=METRIC_TOL,
                                           atol=0, err_msg=f"{arch} {k}")
            for a, b in zip(run["params"], want["params"]):
                assert float(np.abs(a - b).max()) <= tol, arch
            for k in ("m", "v"):
                for a, b in zip(run[k], want[k]):
                    np.testing.assert_allclose(
                        a, b, rtol=1e-3, atol=1e-4 * np.abs(b).max(),
                        err_msg=f"{arch} {k}")
    # the device run's checkpoint restores on the mesh bit for bit
    first = device[TWINS[0]]["params"]
    for r in range(2):
        for a, b in zip(got[r]["restored"], first):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    # and the mesh run's (whole tensors, written by rank 0) off it
    cfg, shape, tc = _train_case(TWINS[0])
    mesh_ckpt = restore_checkpoint(ckpt / "mesh", TRAIN_RUN["steps"] - 1,
                                   abstract_state(cfg, tc))
    for a, b in zip(_leaves(mesh_ckpt["params"]),
                    got[0]["runs"][TWINS[0]]["params"]):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
