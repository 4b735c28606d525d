"""The port's LM training path against the JAX package: the loss, AdamW,
the remat'd micro-batched train step, the data pipeline, checkpoints
and the train loop.

Both packages run the same parameters: a tree drawn with numpy from the
reference's schema (``default_rng`` seeded, its init rules), given to
the reference as arrays and to the port through
``repro_torch.convert``.  The reference's compiled runs (loss and
gradients of four smoke twins, two train steps) happen once, in threads,
in the module fixture ``jax_runs``: XLA compiles outside the
interpreter lock.

Tolerances:
* ``lr_at``, ``softmax_xent`` and ``adamw_update`` (the same float32
  operations, float32 and bf16 moments, with clipping): 1e-6 relative
  elementwise.  The clipping scale comes from the gradients' global
  norm, whose sum the two packages take in another order; a one-ulp
  difference of the scale moves a moment that nearly cancels
  (``beta1 * m ~ -(1 - beta1) * g``) by far more than 1e-6 of itself.
  So the update is compared on gradients whose squares and sums are
  exact in float32 (multiples of 1/8 below 8), where both norms are the
  same float, and the norm itself within 1e-6 on ordinary gradients.
* ``lm_loss`` at float32 compute: the loss within 1e-5 relative, every
  gradient leaf within ``1e-4 * max|leaf|`` (the same operations in
  another summation order; measured: the loss within 1.0e-7, a leaf
  within 1.9e-6 of its largest value, mamba2's ``A_log``).
* a train step: metrics within 1e-5 relative, parameters within
  ``2 * lr_at(opt, 0)`` absolute (Adam's first step moves a weight by
  ``lr`` times the sign of its gradient, which rounding may flip where
  the gradient is ~0).
* remat against no remat: equal, bit for bit, on the CPU (the same
  operations recomputed).
* batches and checkpoints: bit for bit.
"""
import dataclasses
import json
import math
import pathlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import THREADS

from repro.checkpoint import restore_checkpoint as jrestore_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import smoke_config as jsmoke_config
from repro.data import pipeline as jpipeline
from repro.models import lm_loss as jlm_loss
from repro.models import model_schema as jmodel_schema
from repro.models.config import ShapeConfig as JShapeConfig
from repro.models.layers import softmax_xent as jsoftmax_xent
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import lr_at as jlr_at
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import abstract_state as jabstract_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.data import pipeline
from repro_torch.launch.train import train_loop
from repro_torch.models import lm_loss, model_schema
from repro_torch.models.config import ShapeConfig
from repro_torch.models.layers import softmax_xent
from repro_torch.models.schema import _leaves, _unflatten, abstract_params
from repro_torch.optim import OptConfig, adamw_init, adamw_update, lr_at
from repro_torch.train import (TrainConfig, abstract_state, init_state,
                               make_train_step)

ARCHS = ["qwen2-0.5b", "olmoe-1b-7b", "mamba2-2.7b", "seamless-m4t-medium"]
B, S = 2, 16
STEP_ARCH, STEP_B = "qwen2-0.5b", 4
STEP_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)
LOSS_TOL, GRAD_TOL, METRIC_TOL = 1e-5, 1e-4, 1e-5


def _np_params(schema, rng):
    """The reference's schema drawn with numpy, leaf by leaf in
    sorted-key order, by its init rules (fan-in normal, zeros, ones)."""
    if isinstance(schema, dict):
        return {k: _np_params(schema[k], rng) for k in sorted(schema)}
    p = schema
    if p.init in ("zeros", "ones"):
        return np.full(p.shape, p.init == "ones", np.float32)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    std = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (rng.standard_normal(p.shape) * std).astype(np.float32)


def _cfgs(arch):
    """(reference config, port config): the smoke twin at float32
    compute, SSD chunk 8 (two chunks at S 16)."""
    over = {"compute_dtype": "float32", "ssm_chunk": 8}
    return (dataclasses.replace(jsmoke_config(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


def _np_batch(jcfg, batch, seq, step=0):
    ds = jpipeline.dataset_for(jcfg, JShapeConfig("t", seq, batch, "train"),
                               seed=3)
    return jpipeline.make_batch(ds, step)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_grads(arch):
    jcfg, _ = _cfgs(arch)
    params = _np_params(jmodel_schema(jcfg), np.random.default_rng(1))
    batch = _np_batch(jcfg, B, S)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm_loss(p, b, jcfg), has_aux=True))
    (loss, metrics), grads = fn(params, batch)
    return {"params": params, "batch": batch, "loss": float(loss),
            "metrics": _tree_np(metrics), "grads": _tree_np(grads)}


def _jax_step(n_micro):
    jcfg, _ = _cfgs(STEP_ARCH)
    params = _np_params(jmodel_schema(jcfg), np.random.default_rng(4))
    zeros = jax.tree.map(np.zeros_like, params)
    state = {"params": params, "opt": {"m": zeros, "v": zeros},
             "step": np.int32(0)}
    batch = _np_batch(jcfg, STEP_B, S)
    tc = JTrainConfig(opt=JOptConfig(**STEP_OPT), n_micro=n_micro)
    new, metrics = jax.jit(jmake_train_step(jcfg, tc))(state, batch)
    return {"state": _tree_np(state), "batch": batch, "new": _tree_np(new),
            "metrics": _tree_np(metrics)}


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's compiled runs, in the worker's threads."""
    jobs = [("grads", a) for a in ARCHS] + [("step", n) for n in (1, 2)]
    run = lambda job: (_jax_grads if job[0] == "grads" else _jax_step)(
        job[1])
    with ThreadPoolExecutor(min(len(jobs), THREADS)) as pool:
        return dict(zip(jobs, pool.map(run, jobs)))


def _torch_batch(batch):
    return pipeline.place_batch(batch, "cpu")


def _rel(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=0, err_msg=what)


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


# ---------------------------------------------------------------------------
# Optimizer and loss
# ---------------------------------------------------------------------------
def test_lr_at_matches_reference():
    for kw in (STEP_OPT, dict(lr=3e-4, warmup_steps=100, total_steps=10_000,
                              min_lr_ratio=0.1)):
        steps = [0, 1, 2, 5, 9, 10, 99, 100, 101, 5_000, 9_999, 20_000]
        got = [float(lr_at(OptConfig(**kw), s)) for s in steps]
        want = [float(jlr_at(JOptConfig(**kw), s)) for s in steps]
        _rel(got, want, 1e-6, f"lr_at {kw}")
    assert lr_at(OptConfig(), torch.tensor(3, dtype=torch.int32)).dtype == \
        torch.float32


@pytest.mark.parametrize("moments,clip", [("float32", 1.0),
                                          ("bfloat16", 0.05),
                                          ("float32", 1e9)])
def test_adamw_update_matches_reference(moments, clip):
    """Two successive steps (0 and 5) in place against the reference's
    functional update on the same inputs; the second clips the first's
    output again."""
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip=clip,
              weight_decay=0.1, moment_dtype=moments)
    rng = np.random.default_rng(0)
    shapes = {"a": (16, 33), "b": (7,), "c": {"d": (3, 4, 5)}}
    mk = lambda f: jax.tree.map(f, shapes, is_leaf=lambda x: isinstance(
        x, tuple))
    p = mk(lambda s: rng.standard_normal(s).astype(np.float32))
    # gradients with exact squares and sums in float32: multiples of 1/8
    grads = [mk(lambda s: (rng.integers(-63, 64, s) / 8).astype(np.float32))
             for _ in range(2)]
    jp = jax.tree.map(jnp.asarray, p)
    jst = {"m": jax.tree.map(lambda x: jnp.zeros(x.shape, moments), jp),
           "v": jax.tree.map(lambda x: jnp.zeros(x.shape, moments), jp)}
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), p)
    tst = adamw_init(tp, OptConfig(**kw))
    for step, g in zip((0, 5), grads):
        jp, jst, jmet = jadamw_update(jp, jax.tree.map(jnp.asarray, g), jst,
                                      step, JOptConfig(**kw))
        tg = jax.tree.map(torch.from_numpy, g)
        tp2, tst2, met = adamw_update(tp, tg, tst, step, OptConfig(**kw))
        assert tp2 is tp and tst2 is tst            # in place
        _rel(float(met["grad_norm"]), float(jmet["grad_norm"]), 0, "gnorm")
        _rel(float(met["lr"]), float(jmet["lr"]), 1e-6, "lr")
        for what, got, want in (("params", tp, jp), ("m", tst["m"], jst["m"]),
                                ("v", tst["v"], jst["v"])):
            for (name, a), (_, b) in zip(_leaf_items(got), _leaf_items(want)):
                assert a.dtype == getattr(torch, str(b.dtype)), (what, name)
                _rel(a.float().numpy(), np.asarray(b, np.float32), 1e-6,
                     f"step {step} {what} {name}")
    # the global norm on ordinary gradients
    g = mk(lambda s: rng.standard_normal(s).astype(np.float32))
    _, _, jmet = jadamw_update(jax.tree.map(jnp.asarray, p),
                               jax.tree.map(jnp.asarray, g), jst, 0,
                               JOptConfig(**kw))
    _, _, met = adamw_update(jax.tree.map(torch.from_numpy, p),
                             jax.tree.map(torch.from_numpy, g),
                             adamw_init(tp, OptConfig(**kw)), 0,
                             OptConfig(**kw))
    _rel(float(met["grad_norm"]), float(jmet["grad_norm"]), 1e-6, "gnorm")


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(5)
    lg = (rng.standard_normal((2, 9, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, (2, 9)).astype(np.int32)
    got = softmax_xent(torch.from_numpy(lg), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.ndim == 0
    _rel(float(got), float(jsoftmax_xent(lg, labels)), 1e-6, "xent")
    bf = torch.from_numpy(lg).to(torch.bfloat16)
    _rel(float(softmax_xent(bf, torch.from_numpy(labels))),
         float(jsoftmax_xent(jnp.asarray(bf.float().numpy(), jnp.bfloat16),
                             labels)), 1e-6, "xent of bf16 logits")


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------
def _port_grads(params, batch, cfg, remat=True):
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    loss, metrics = lm_loss(_unflatten(params, leaves), batch, cfg,
                            remat=remat)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(jax_runs, arch):
    run = jax_runs[("grads", arch)]
    _, cfg = _cfgs(arch)
    params = lm_params_from_jax(run["params"], device="cpu")
    loss, metrics, grads = _port_grads(params, _torch_batch(run["batch"]),
                                       cfg)
    _rel(float(loss), run["loss"], LOSS_TOL, "loss")
    for k in ("xent", "aux"):
        _rel(float(metrics[k]), float(run["metrics"][k]), LOSS_TOL, k)
    if cfg.moe_experts:
        assert float(metrics["aux"]) > 0
    want = _leaf_items(run["grads"])
    assert len(grads) == len(want)
    for g, (name, w) in zip(grads, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        scale = np.abs(w).max()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_no_remat(jax_runs, arch):
    """The same loss and gradients with every layer's activations kept,
    and at the default bf16 compute too."""
    run = jax_runs[("grads", arch)]
    _, cfg = _cfgs(arch)
    params = lm_params_from_jax(run["params"], device="cpu")
    batch = _torch_batch(run["batch"])
    for c in (cfg, smoke_config(arch)):
        la, _, ga = _port_grads(params, batch, c, remat=True)
        lb, _, gb = _port_grads(params, batch, c, remat=False)
        assert float(la) == float(lb)
        for a, b in zip(ga, gb):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(jax_runs, n_micro):
    run = jax_runs[("step", n_micro)]
    _, cfg = _cfgs(STEP_ARCH)
    state = train_state_from_jax(run["state"], device="cpu")
    tc = TrainConfig(opt=OptConfig(**STEP_OPT), n_micro=n_micro)
    new, metrics = make_train_step(cfg, tc)(state, _torch_batch(run["batch"]))
    assert new is state and int(state["step"]) == 1
    assert state["step"].dtype == torch.int32
    assert sorted(metrics) == sorted(run["metrics"])
    for k, v in metrics.items():
        _rel(float(v), float(run["metrics"][k]), METRIC_TOL, k)
    if n_micro > 1:
        assert float(metrics["aux"]) == 0.0
    tol = 2 * float(lr_at(tc.opt, 0))
    for (name, got), (_, want) in zip(_leaf_items(state["params"]),
                                      _leaf_items(run["new"]["params"])):
        err = np.abs(got.numpy() - want).max()
        assert err <= tol, (name, err, tol)
    for k in ("m", "v"):
        for (name, got), (_, want) in zip(
                _leaf_items(state["opt"][k]),
                _leaf_items(run["new"]["opt"][k])):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{k} {name}")


def test_train_step_bf16_grad_buffer():
    """``grad_dtype="bfloat16"`` accumulates into a bf16 buffer; the
    step still trains every leaf (a finite, moved parameter tree)."""
    cfg = smoke_config("qwen2-0.5b")
    tc = TrainConfig(opt=OptConfig(**STEP_OPT), n_micro=2,
                     grad_dtype="bfloat16")
    state = init_state(cfg, tc, torch.Generator().manual_seed(0), "cpu")
    before = [p.clone() for p in _leaves(state["params"])]
    batch = pipeline.place_batch(pipeline.make_batch(
        pipeline.dataset_for(cfg, ShapeConfig("t", 8, 4, "train")), 0), "cpu")
    _, metrics = make_train_step(cfg, tc)(state, batch)
    assert all(math.isfinite(float(v)) for v in metrics.values())
    for a, b in zip(before, _leaves(state["params"])):
        assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-26b",
                                  "seamless-m4t-medium"])
def test_make_batch_bit_identical(arch):
    """Tokens, labels and (VLM) prefix / (enc-dec) frames, at two steps;
    ``place_batch`` gives int64 ids and float32 inputs."""
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    ds = pipeline.dataset_for(cfg, ShapeConfig("t", 24, 3, "train"), seed=7)
    jds = jpipeline.dataset_for(jcfg, JShapeConfig("t", 24, 3, "train"),
                                seed=7)
    assert dataclasses.asdict(ds) == dataclasses.asdict(jds)
    want_keys = {"tokens", "labels"} | (
        {"prefix"} if cfg.family == "vlm" else set()) | (
        {"frames"} if cfg.family == "encdec" else set())
    for step in (0, 11):
        got, want = pipeline.make_batch(ds, step), jpipeline.make_batch(
            jds, step)
        assert set(got) == set(want) == want_keys
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        placed = pipeline.place_batch(got, "cpu")
        for k, t in placed.items():
            assert t.dtype == (torch.int64 if k in ("tokens", "labels")
                               else torch.float32)
            np.testing.assert_array_equal(t.numpy(), got[k])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    return {"params": {"w": w, "b": jnp.asarray(b, jnp.bfloat16)},
            "step": np.int32(7)}


def _torch_tree(t):
    return {"params": {"w": torch.from_numpy(np.array(t["params"]["w"])),
                       "b": torch.from_numpy(np.asarray(
                           t["params"]["b"]).view(np.uint16).copy()).view(
                           torch.bfloat16)},
            "step": torch.tensor(int(t["step"]), dtype=torch.int32)}


def _abstract(t):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(np.shape(x),
                                                       jnp.asarray(x).dtype),
                        t)


def _same(torch_leaf, jax_leaf):
    a = torch_leaf.contiguous().view(-1).view(torch.uint8).numpy() \
        if torch_leaf.ndim else torch_leaf.reshape(1).view(torch.uint8).numpy()
    b = np.ascontiguousarray(np.asarray(jax_leaf)).reshape(-1).view(np.uint8)
    return np.array_equal(a, b)


def test_checkpoint_cross_package_roundtrip(tmp_path):
    """The port writes and the reference reads, and the other way round,
    bf16 leaf included, byte for byte."""
    ref = _tree()
    port = _torch_tree(ref)
    save_checkpoint(tmp_path / "port", 3, port)
    got = jrestore_checkpoint(tmp_path / "port", 3, _abstract(ref),
                              verify=True)
    assert got["params"]["b"].dtype == jnp.bfloat16
    for (name, a), (_, b) in zip(_leaf_items(port), _leaf_items(got)):
        assert _same(a, b), name

    jsave_checkpoint(tmp_path / "ref", 4, jax.tree.map(jnp.asarray, ref))
    like = jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), port)
    back = restore_checkpoint(tmp_path / "ref", 4, like, verify=True)
    assert back["params"]["b"].dtype == torch.bfloat16
    assert back["step"].dtype == torch.int32 and back["step"].ndim == 0
    for (name, a), (_, b) in zip(_leaf_items(back), _leaf_items(ref)):
        assert _same(a, b), name
    m1 = json.loads((tmp_path / "port/step_3/manifest.json").read_text())
    m2 = json.loads((tmp_path / "ref/step_4/manifest.json").read_text())
    assert m1["leaves"].keys() == m2["leaves"].keys()
    for k in m1["leaves"]:
        a, b = m1["leaves"][k], m2["leaves"][k]
        assert (a["shape"], a["dtype"]) == (b["shape"], b["dtype"])
        assert [(c["file"], c["crc32"], c["dtype"]) for c in a["chunks"]] \
            == [(c["file"], c["crc32"], c["dtype"]) for c in b["chunks"]]


def test_train_state_restores_against_reference_abstract_state(tmp_path):
    """A port train state (bf16 moments) saved by the port restores in
    the reference against its own ``abstract_state``: the leaf names,
    shapes and dtypes agree.  And back into the port."""
    jcfg, cfg = jsmoke_config("olmoe-1b-7b"), smoke_config("olmoe-1b-7b")
    opt = dict(moment_dtype="bfloat16")
    tc = TrainConfig(opt=OptConfig(**opt))
    state = init_state(cfg, tc, torch.Generator().manual_seed(0), "cpu")
    for m in _leaves(state["opt"]["m"]):
        m.normal_()
    state["step"].fill_(5)
    save_checkpoint(tmp_path, 5, state)
    got = jrestore_checkpoint(tmp_path, 5, jabstract_state(
        jcfg, JTrainConfig(opt=JOptConfig(**opt))))
    assert int(got["step"]) == 5
    assert len(_leaf_items(got)) == len(_leaf_items(state))
    for (name, a), (jname, b) in zip(_leaf_items(state), _leaf_items(got)):
        assert name == jname and _same(a, b), name
    back = restore_checkpoint(tmp_path, 5, abstract_state(cfg, tc))
    for (name, a), (_, b) in zip(_leaf_items(state), _leaf_items(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert all(t.device.type == "meta" for t in
               _leaves(abstract_params(model_schema(cfg))))


def test_checkpoint_assembles_chunks(tmp_path):
    """A leaf written in two row chunks (as a sharded mesh writes it)
    restores whole."""
    ref = _tree(1)
    path = save_checkpoint(tmp_path, 0, _torch_tree(ref))
    man = json.loads((path / "manifest.json").read_text())
    w = ref["params"]["w"]
    chunks = []
    for start, stop in ((0, 3), (3, 8)):
        part = np.ascontiguousarray(w[start:stop])
        name = f"params_w__{start}-{stop}_0-16.npy"
        np.save(path / name, part.reshape(-1).view(np.uint8))
        chunks.append({"file": name, "start": [start, 0], "stop": [stop, 16],
                       "shape": list(part.shape), "dtype": "float32",
                       "crc32": 0})
    (path / man["leaves"]["params/w"]["chunks"][0]["file"]).unlink()
    man["leaves"]["params/w"]["chunks"] = chunks
    (path / "manifest.json").write_text(json.dumps(man))
    back = restore_checkpoint(tmp_path, 0, _torch_tree(ref))
    np.testing.assert_array_equal(back["params"]["w"].numpy(), w)


def test_checkpoint_keep_tmp_verify_and_async_error(tmp_path):
    state = _torch_tree(_tree())
    for s in range(5):
        save_checkpoint(tmp_path / "gc", s, state, keep=2)
    assert sorted(p.name for p in (tmp_path / "gc").glob("step_*")) == \
        ["step_3", "step_4"]

    tmp = tmp_path / "gc" / "step_9.tmp"
    tmp.mkdir()
    (tmp / "garbage.npy").write_bytes(b"xx")       # a dead writer's
    assert latest_step(tmp_path / "gc") == 4

    chunk = next((tmp_path / "gc" / "step_4").glob("params_w*.npy"))
    raw = bytearray(chunk.read_bytes())
    raw[-1] ^= 0xFF
    chunk.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(tmp_path / "gc", 4, state, verify=True)
    restore_checkpoint(tmp_path / "gc", 4, state)  # unverified: reads

    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    mgr = CheckpointManager(str(blocker))
    mgr.save(1, state)                             # fails off-thread
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                     # raised once

    mgr = CheckpointManager(str(tmp_path / "async"))
    mgr.save(2, state)
    state["params"]["w"].add_(1.0)                 # the step moves on
    mgr.wait()
    assert mgr.last_save["bytes"] == 8 * 16 * 4 + 16 * 2 + 4
    assert mgr.last_save["files_s"] >= 0 and mgr.last_save["d2h_s"] >= 0
    step, back = mgr.restore_latest(state)
    assert step == 2
    np.testing.assert_array_equal(back["params"]["w"].numpy() + 1.0,
                                  state["params"]["w"].numpy())


# ---------------------------------------------------------------------------
# The train loop
# ---------------------------------------------------------------------------
def test_crash_resume_is_bit_identical(tmp_path):
    """Crash at step 9 with a checkpoint every 4 steps, resume: the
    restart replays steps 8-9 from step 7's state, and every loss equals
    an uninterrupted run's bit for bit."""
    cfg = smoke_config("qwen2-0.5b")
    shape = ShapeConfig("t", 32, 2, "train")
    kw = dict(steps=12, device="cpu", log_every=1000,
              print_fn=lambda *a: None)
    _, whole = train_loop(cfg, shape, **kw)
    _, first = train_loop(cfg, shape, ckpt_dir=str(tmp_path), ckpt_every=4,
                          kill_at=9, **kw)
    assert latest_step(tmp_path) == 7
    logs, stats = [], {}
    _, rest = train_loop(cfg, shape, ckpt_dir=str(tmp_path), ckpt_every=4,
                         hb_dir=str(tmp_path / "hb"),
                         **dict(kw, print_fn=logs.append), stats=stats)
    assert any("resuming at 8" in m for m in logs)
    assert stats["restored_step"] == 7 and len(rest) == 4
    assert first == whole[:10] and rest == whole[8:]
    assert latest_step(tmp_path) == 11
    assert [s["step"] for s in stats["saves"]] == [11]
    hb = json.loads((tmp_path / "hb" / "hb_host0.json").read_text())
    assert hb["step"] == 11


@pytest.mark.parametrize("arch,steps,margin", [
    ("qwen2-0.5b", 25, 0.2),
    ("mamba2-2.7b", 25, 0.2),
    ("olmoe-1b-7b", 45, 0.1),
])
def test_loss_decreases(arch, steps, margin):
    """The reference's archs, steps and margins (``tests/test_train.py``)."""
    cfg = smoke_config(arch)
    shape = ShapeConfig("t", 64, 4, "train")
    _, losses = train_loop(cfg, shape, steps=steps, device="cpu",
                           tc=TrainConfig(opt=OptConfig(
                               lr=1e-2, warmup_steps=5, total_steps=steps)),
                           log_every=1000, print_fn=lambda *a: None)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - margin, (first, last)


def test_train_loop_default_device_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(smoke_config("qwen2-0.5b"), ShapeConfig("t", 8, 2, "train"),
                   steps=1, print_fn=lambda *a: None)
