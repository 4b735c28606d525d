"""The port's blockwise attention (``models.attention._flash`` over the
``repro_torch::flash_fwd``/``flash_bwd`` operators) against the
reference's ``_flash`` and ``jax.grad`` of it, on the CPU, where the
operators run their plain versions.

Inputs are drawn with numpy (``default_rng`` seeded) at B 2, S 64, Hq 4,
Hkv 2, D 16 with ``q_block`` 16 and ``kv_block`` 32: four query blocks
and two kv blocks, with the plain version summing in the reference's
block order.  The reference's compiled runs happen once, in threads, in
the module fixture ``jax_runs``.

Tolerances, as a share of the reference's largest magnitude:
* float32: the forward within 1e-6, the gradients within 1e-5 (the same
  float32 operations in another order; measured 3e-7 and 2e-6);
* bfloat16 (inputs, output and gradients in bf16, arithmetic in float32
  in both packages): the forward within 2^-7, one bf16 rounding of the
  largest value; the gradients within 2e-2: they are rounded to bf16,
  and the port's backward takes ``rowsum(dO * o)`` from the bf16 output
  it saved, where ``jax.grad`` differentiates the float32 one;
* the smoke twin's loss within 1e-5 relative and each gradient leaf
  within 1e-4 of its largest value, as ``test_torch_train.py`` holds
  ``lm_loss``;
* the dry run's counted FLOPs: equal;
* the bf16 route's split of a float32 operand (``ref.split_bf16``):
  exact, no tolerance.
"""
import dataclasses
import math
import struct
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from conftest import THREADS

from repro.configs import smoke_config as jsmoke_config
from repro.data import pipeline as jpipeline
from repro.models import lm_loss as jlm_loss
from repro.models import model_schema as jmodel_schema
from repro.models.attention import _flash as jflash
from repro.models.config import ShapeConfig as JShapeConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import pipeline
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref, split_bf16
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import fake_world
from repro_torch.models import lm_loss
from repro_torch.models.attention import _flash
from repro_torch.models.config import ShapeConfig
from repro_torch.models.schema import _leaves, _unflatten

B, S, HQ, HKV, D = 2, 64, 4, 2, 16
Q_BLOCK, KV_BLOCK = 16, 32
# (causal, dtype, q_offset)
CASES = [(True, "float32", 0), (False, "float32", 0), (True, "bfloat16", 0),
         (False, "bfloat16", 0), (True, "float32", 24)]
TOL = {"float32": (1e-6, 1e-5), "bfloat16": (2.0 ** -7, 2e-2)}
LM_ARCH, LM_B, LM_S = "qwen2-0.5b", 1, 1024    # two 512 blocks each way
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    w = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    return q, k, v, w


def _jax_flash(case):
    """The reference's output and ``jax.grad`` of ``sum(o * w)``."""
    causal, dtype, off = case
    q, k, v, w = _inputs(7)
    dt = jnp.dtype(dtype)
    args = [jnp.asarray(x).astype(dt) for x in (q, k, v)]

    def f(q, k, v):
        o = jflash(q, k, v, causal=causal, q_block=Q_BLOCK,
                   kv_block=KV_BLOCK, q_offset=off)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, o), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                               has_aux=True))(*args)
    f32 = lambda x: np.asarray(x.astype(jnp.float32))
    return {"o": f32(o), "grads": [f32(g) for g in grads]}


def _np_params(schema, rng):
    if isinstance(schema, dict):
        return {k: _np_params(schema[k], rng) for k in sorted(schema)}
    p = schema
    if p.init in ("zeros", "ones"):
        return np.full(p.shape, p.init == "ones", np.float32)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    std = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (rng.standard_normal(p.shape) * std).astype(np.float32)


def _jax_lm():
    """The smoke twin's loss and gradients at float32 compute over a
    sequence of two 512 blocks."""
    jcfg = dataclasses.replace(jsmoke_config(LM_ARCH),
                               compute_dtype="float32")
    params = _np_params(jmodel_schema(jcfg), np.random.default_rng(2))
    ds = jpipeline.dataset_for(
        jcfg, JShapeConfig("t", LM_S, LM_B, "train"), seed=3)
    batch = jpipeline.make_batch(ds, 0)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm_loss(p, b, jcfg),
                                    has_aux=True))
    (loss, _), grads = fn(params, batch)
    return {"params": params, "batch": batch, "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads)}


@pytest.fixture(scope="module")
def jax_runs():
    jobs = [("flash", c) for c in CASES] + [("lm", None)]
    run = lambda job: _jax_flash(job[1]) if job[0] == "flash" else _jax_lm()
    with ThreadPoolExecutor(min(len(jobs), THREADS)) as pool:
        return dict(zip(jobs, pool.map(run, jobs)))


def _port_flash(case):
    causal, dtype, off = case
    q, k, v, w = _inputs(7)
    dt = getattr(torch, dtype)
    ts = [torch.from_numpy(x).to(dt).requires_grad_() for x in (q, k, v)]
    o = _flash(*ts, causal=causal, q_block=Q_BLOCK, kv_block=KV_BLOCK,
               q_offset=off)
    (o.float() * torch.from_numpy(w)).sum().backward()
    return o.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


def _close(got, want, tol, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= tol * scale, (what, err, scale, tol)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_flash_forward_matches_reference(jax_runs, case):
    o, _ = _port_flash(case)
    _close(o, jax_runs[("flash", case)]["o"], TOL[case[1]][0], "o")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_flash_grads_match_jax_grad(jax_runs, case):
    _, grads = _port_flash(case)
    for name, g, w in zip("qkv", grads, jax_runs[("flash", case)]["grads"]):
        _close(g, w, TOL[case[1]][1], f"d{name}")


@pytest.mark.parametrize("causal,off,sq,sk", [(True, 0, 50, 50),
                                              (True, 13, 37, 50),
                                              (False, 0, 45, 29)])
def test_flash_ragged_blocks_match_dense_softmax(causal, off, sq, sk):
    """Lengths that are no multiple of either block (the reference
    asserts there; the port serves prompts of any length) against a
    dense float64 softmax; the backward against autograd through it."""
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((B, sq, HQ, D))
    k = rng.standard_normal((B, sk, HKV, D))
    v = rng.standard_normal((B, sk, HKV, D))
    w = rng.standard_normal((B, sq, HQ, D))
    port = [torch.tensor(x, dtype=torch.float32, requires_grad=True)
            for x in (q, k, v)]
    o = _flash(*port, causal=causal, q_block=Q_BLOCK, kv_block=KV_BLOCK,
               q_offset=off)
    (o * torch.from_numpy(w).float()).sum().backward()
    dense = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    qg = dense[0].reshape(B, sq, HKV, HQ // HKV, D) * D ** -0.5
    s = torch.einsum("btkgd,bukd->btkgu", qg, dense[1])
    if causal:
        keep = (torch.arange(sq)[:, None] + off) >= torch.arange(sk)[None]
        s = s.masked_fill(~keep[None, :, None, None, :], -torch.inf)
    want = torch.einsum("btkgu,bukd->btkgd", torch.softmax(s, -1),
                        dense[2]).reshape(B, sq, HQ, D)
    (want * torch.from_numpy(w)).sum().backward()
    _close(o.detach().numpy(), want.detach().numpy(), 1e-6, "o")
    for name, a, b in zip("qkv", port, dense):
        _close(a.grad.numpy(), b.grad.numpy(), 1e-5, f"d{name}")


@pytest.mark.parametrize("causal,dtype", [(True, torch.float32),
                                          (False, torch.bfloat16)])
def test_flash_ops_pass_opcheck(causal, dtype):
    """Schema, fake implementation and autograd registration of both
    operators (``torch.library.opcheck``)."""
    q, k, v, _ = _inputs(3)
    q5 = torch.from_numpy(q).reshape(B, S, HKV, HQ // HKV, D).to(dtype)
    k, v = (torch.from_numpy(x).to(dtype) for x in (k, v))
    args = (causal, Q_BLOCK, KV_BLOCK, 8 if causal else 0)
    fwd_in = [t.clone().requires_grad_() for t in (q5, k, v)]
    torch.library.opcheck(torch.ops.repro_torch.flash_fwd,
                          (*fwd_in, *args))
    o, lse = torch.ops.repro_torch.flash_fwd(q5, k, v, *args)
    torch.library.opcheck(torch.ops.repro_torch.flash_bwd,
                          (torch.ones_like(o), q5, k, v, o, lse, *args))


def test_flash_fake_shapes_and_flop_formula():
    """Meta tensors take the fake implementation; the FLOP formula is
    every block pair's, 4 B Sq Sk Hq D forward and twice that backward."""
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.empty(B, S, HKV, HQ // HKV, D, device="meta",
                    dtype=torch.bfloat16, requires_grad=True)
    k = torch.empty(B, S // 2, HKV, D, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        o = ops.flash_attention(q, k, v, causal=False, q_block=Q_BLOCK,
                                kv_block=KV_BLOCK)
        o.sum().backward()
    assert o.shape == q.shape and o.dtype == q.dtype
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    fwd = 4 * B * S * (S // 2) * HQ * D
    assert fc.get_total_flops() == 3 * fwd


def test_plain_version_is_the_reference_block_loop():
    """``flash_fwd_ref`` at one block each way equals a dense float32
    softmax; its lse is the row's log-sum-exp of the scaled scores."""
    q, k, v, _ = _inputs(11)
    q5 = torch.from_numpy(q).reshape(B, S, HKV, HQ // HKV, D)
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    o, lse = flash_fwd_ref(q5, k, v, causal=False, q_block=S, kv_block=S)
    s = torch.einsum("btkgd,bukd->btkgu", q5.double() * D ** -0.5,
                     k.double())
    _close(lse.numpy(), torch.logsumexp(s, -1).numpy(), 1e-6, "lse")
    want = torch.einsum("btkgu,bukd->btkgd", torch.softmax(s, -1),
                        v.double())
    _close(o.numpy(), want.numpy(), 1e-6, "o")


def test_lm_loss_over_two_blocks_matches_reference(jax_runs):
    """A smoke twin's ``lm_loss`` and gradients (remat on, float32
    compute) at a sequence of two 512 blocks against the reference's
    ``value_and_grad``."""
    run = jax_runs[("lm", None)]
    cfg = dataclasses.replace(smoke_config(LM_ARCH), compute_dtype="float32")
    params = lm_params_from_jax(run["params"], device="cpu")
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    loss, _ = lm_loss(_unflatten(params, leaves),
                      pipeline.place_batch(run["batch"], "cpu"), cfg,
                      remat=True)
    grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    assert abs(loss - run["loss"]) <= LOSS_TOL * abs(run["loss"])
    want = jax.tree_util.tree_leaves_with_path(run["grads"])
    want = sorted((jax.tree_util.keystr(p), w) for p, w in want)
    assert len(grads) == len(want)
    for g, (name, w) in zip(grads, want):
        assert tuple(g.shape) == w.shape, name
        err = np.abs(g.numpy() - w).max()
        assert err <= LEAF_TOL * np.abs(w).max(), (name, err)


def test_dryrun_flops_equal_analytic_with_flash():
    """On a one-rank mesh the dry run's counted matmul FLOPs of a smoke
    twin equal ``dense_train_flops`` at two 512 blocks; the attention
    operators (forward, remat's recompute and backward) on the twin's
    bf16 activations are priced as bf16, over the half-products their
    tensor-core kernels need: twice the forward's FLOPs, 11/4 of the
    backward's."""
    if dist.is_initialized():
        dist.destroy_process_group()
    fake_world(1)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = smoke_config(LM_ARCH)
        rec = tdry.build(LM_ARCH, ShapeConfig("t", LM_S, 2, "train"),
                         "host", {"cfg_replace": dataclasses.asdict(cfg)},
                         mesh=mesh)
        want = tdry.dense_train_flops(cfg, 2, LM_S)
        assert rec["cost"]["flops"] == sum(want.values())
        # float32 products: the logits head (float32 operands, 6 T d V);
        # bf16: the projections and the attention, whose formula counts
        # one forward pass (attn) twice with remat and the backward as 2
        # attn: 2 * 2 attn + 11 / 4 * 2 attn in half-products.
        head = 6 * 2 * LM_S * cfg.d_model * cfg.vocab_padded
        attn = want["attention"] // 3
        by = rec["cost"]["flops_by_dtype"]
        assert by["float32"] == head
        assert by["bfloat16"] == sum(want.values()) - head - 4 * attn \
            + 2 * 2 * attn + 11 / 4 * 2 * attn
    finally:
        dist.destroy_process_group()


def _split_inputs(kind):
    """float32 values the bf16 route splits: seeded random values over
    many binades, ``exp`` outputs in (0, 1] (probabilities), and 0, 1,
    the largest bf16 and the largest float32 whose split is finite."""
    rng = np.random.default_rng(5)
    if kind == "binades":
        x = rng.uniform(1, 2, 4096) * 2.0 ** rng.integers(-100, 100, 4096)
        x *= rng.choice([-1.0, 1.0], 4096)
    elif kind == "exp":
        x = np.exp(-rng.uniform(0, 60, 4096))
        x[:3] = [1.0, np.exp(-1e-7), np.exp(-59.9)]
    else:
        x = np.array([0.0, 1.0, -1.0, float(torch.finfo(torch.bfloat16).max),
                      struct.unpack("<f", struct.pack("<I", 0x7F7F7FFF))[0]])
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["binades", "exp", "special"])
def test_split_bf16_is_exact(kind):
    """hi + mid + lo == x exactly (in float64), each piece a bf16 value
    that its float32 residual held exactly: lo is x - hi - mid itself."""
    x = _split_inputs(kind)
    hi, mid, lo = split_bf16(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    x64 = x.double()
    assert torch.equal(hi.double() + mid.double() + lo.double(), x64)
    assert torch.equal(lo.double(), x64 - hi.double() - mid.double())
    assert torch.equal(mid.double(), (x64 - hi.double()).to(
        torch.bfloat16).double())
    assert bool(torch.isfinite(hi).all())


@pytest.mark.parametrize("kind", ["binades", "exp"])
def test_split_products_equal_float32_products(kind):
    """With v in bf16, hi v + mid v + lo v (each product exact in
    float64) is P v: every product equal, and each row's sum (exactly
    rounded, ``math.fsum``) equal to P v's."""
    p = _split_inputs(kind).reshape(64, 64)
    rng = np.random.default_rng(6)
    v = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)) \
        .to(torch.bfloat16).double()
    parts = [t.double()[:, :, None] * v[None] for t in split_bf16(p)]
    want = p.double()[:, :, None] * v[None]          # [row, k, n]
    assert torch.equal(parts[0] + parts[1] + parts[2], want)
    for r in range(0, 64, 9):
        for n in range(16):
            got = math.fsum(float(t[r, k, n]) for t in parts
                            for k in range(64))
            assert got == math.fsum(want[r, :, n].tolist())


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_wrappers_route_by_dtype(D):
    """The C entries choose the route by the flag the wrappers pass them:
    set for bf16 operands (tensor cores), clear for float32 ones (FFMA);
    the wrappers' checks refuse operands no route takes."""
    q = torch.zeros(1, 3, 2, 2, D)
    k = torch.zeros(1, 5, 2, D)
    for dt, flag in ((torch.bfloat16, 1), (torch.float32, 0)):
        assert fa._dims(q.to(dt), k.to(dt), True, 0)[8] == flag
    for qd, kd in ((q.half(), k.half()), (q.bfloat16(), k)):
        with pytest.raises(ValueError, match="head sizes"):
            fa._checked(qd, kd, kd)
    with pytest.raises(ValueError, match="CUDA"):   # no kernel on the CPU
        fa._checked(q.bfloat16(), k.bfloat16(), k.bfloat16())
