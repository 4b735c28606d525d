"""The SSD mixer split by heads over ``model``, as the reference anchors
it (``src/repro/models/mamba.py`` constrains the scan's inputs to
``("batch", None, None, "ssm", None)``, and ``"ssm"`` maps to
``"model"``), and the dry run's pricing of the bf16 attention.

One spawned 2-rank gloo group at ``(data=1, model=2)`` runs, for the
Mamba-2 and the jamba smoke twins at float32: two train steps through
``train_loop(mesh=)``, and a prefill plus two greedy decode steps on
parameters drawn with numpy (every leaf, so that the per-head vectors
``A_log``, ``dt_bias``, ``D`` and the norm differ by head).  Each rank
also records the heads and the conv channels that its SSD body saw.
The group starts with the module's first test and is read by the
tests that need it.  The one-card runs are the same functions on the
CPU without a mesh.

Both sides run on one thread: a float32 matmul's order of summation
follows the thread count.  Tolerances: ``tests/test_torch_dist.py``'s
for train steps (losses and
gradient norms 1e-5 relative, AdamW moments 1e-3 relative with
``1e-4 * max`` absolute, parameters the two steps' summed
``2 * lr_at(opt, s)``); serving logits within 1e-5 of the largest, the
greedy tokens equal.  The mesh runs the same float32 operations on
each rank's heads and sums the norm's mean square and ``out_proj``'s
product across ranks in another order.
"""
import dataclasses
import multiprocessing as mp

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.launch import cost as tcost
from repro_torch.models.config import ShapeConfig

TWINS = ("mamba2-2.7b", "jamba-v0.1-52b")
TRAIN_RUN = dict(steps=2, print_fn=lambda m: None)
PROMPT, DECODE, SERVE_BATCH = 16, 2, 2
METRIC_TOL = 1e-5
LOGIT_TOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(smoke_config(arch), compute_dtype="float32")


def _train_case(arch):
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig
    tc = TrainConfig(opt=OptConfig(warmup_steps=2, total_steps=4),
                     n_micro=1)
    # 64 tokens: two of the twins' 32-token chunks, the state carried
    return _cfg(arch), ShapeConfig("heads", 64, 2, "train"), tc


def _numpy_params(cfg, seed):
    """Every leaf of ``cfg``'s schema drawn with numpy: a normal leaf at
    its init scale, the others (zeros, ones) as 0.5 + 0.1 N(0, 1)."""
    from repro_torch.models import model_schema
    from repro_torch.models.schema import _leaves, _unflatten
    rng = np.random.default_rng(seed)
    schema = model_schema(cfg)
    out = []
    for p in _leaves(schema):
        z = rng.standard_normal(p.shape).astype(np.float32)
        if p.init == "normal":
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            std = p.scale if p.scale is not None else fan_in ** -0.5
            out.append(torch.from_numpy(z * np.float32(std)))
        else:
            out.append(torch.from_numpy(np.float32(0.5) + 0.1 * z))
    return _unflatten(schema, out)


def _prompt(cfg, seed):
    rng = np.random.default_rng(seed + 1)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_BATCH,
                                                        PROMPT)))


def _serve(cfg, params, tokens):
    """Prefill ``tokens``, then ``DECODE`` greedy steps: (each step's
    logits [B, V] as numpy, the tokens chosen)."""
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    prefill = make_prefill_step(cfg, PROMPT + DECODE + 1)
    step = make_decode_step(cfg)
    cache, lg, pos = prefill(params, {"tokens": tokens})
    tok = torch.argmax(lg, -1).to(torch.int32)
    logits, toks = [lg], [tok]
    for i in range(DECODE):
        tok, lg, cache = step(params, tok, pos + i, cache)
        logits.append(lg)
        toks.append(tok)

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()
    return [whole(t) for t in logits], [whole(t) for t in toks]


def _record(state, losses, stats):
    from repro_torch.models.schema import _leaves

    def arrays(tree):
        return [(p.full_tensor() if hasattr(p, "full_tensor") else p).numpy()
                for p in _leaves(tree)]
    return {"losses": losses, "grad_norm": stats["grad_norm"],
            "params": arrays(state["params"]),
            "m": arrays(state["opt"]["m"]), "v": arrays(state["opt"]["v"])}


def _heads_rank(rank, store_path, q, seed=0):
    """One rank of the ``(data=1, model=2)`` CPU mesh: each twin's two
    train steps (``train_loop``'s ``seed``) and its prefill and decode
    steps (numpy seed ``7 + seed``), and the (heads, conv channels) of
    every SSD body call.  Puts (rank, results) on ``q``."""
    torch.set_num_threads(1)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.ctx import act_rules
    from repro_torch.distributed.sharding import (batch_pspecs,
                                                  distribute_tree)
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import mamba, model_schema
    from repro_torch.models.schema import make_rules, pspecs
    seen = []
    inputs = mamba._ssd_inputs

    def counted(cfg, dt_bias, A_log, xBC, dt):
        seen.append((dt.shape[-1], xBC.shape[-1]))
        return inputs(cfg, dt_bias, A_log, xBC, dt)
    mamba._ssd_inputs = counted
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    try:
        mesh = host_mesh("cpu")
        rules = make_rules(mesh)
        out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        for arch in TWINS:
            seen.clear()
            cfg, shape, tc = _train_case(arch)
            stats = {}
            state, losses = train_loop(cfg, shape, tc=tc, mesh=mesh,
                                       stats=stats, seed=seed, **TRAIN_RUN)
            rec = _record(state, losses, stats)
            params = distribute_tree(_numpy_params(cfg, 7 + seed), mesh,
                                     pspecs(model_schema(cfg), rules))
            batch = {"tokens": _prompt(cfg, 7 + seed)}
            batch = distribute_tree(batch, mesh, batch_pspecs(batch, rules))
            with act_rules(rules), implicit_replication():
                rec["logits"], rec["tokens"] = _serve(cfg, params,
                                                      batch["tokens"])
            rec["seen"] = sorted(set(seen))
            out[arch] = rec
        q.put((rank, out))
    finally:
        dist.destroy_process_group()


def start_ranks(store, seed=0):
    """Spawns the two ranks with the gloo file store at ``store``.
    Returns (``result()``, which waits for them and returns their
    results by rank, and the processes)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_heads_rank, args=(r, store, q, seed))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}

    def result():
        if not got:
            got.update(q.get(timeout=80) for _ in procs)
            for p in procs:
                p.join(timeout=15)
                assert not p.is_alive() and p.exitcode == 0
        return got
    return result, procs


def one_card_runs(seed=0):
    """Each twin's two train steps and its serving steps on the CPU, on
    one thread as each rank runs."""
    from repro_torch.launch.train import train_loop
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arch in TWINS:
            cfg, shape, tc = _train_case(arch)
            stats = {}
            state, losses = train_loop(cfg, shape, tc=tc, device="cpu",
                                       stats=stats, seed=seed, **TRAIN_RUN)
            rec = _record(state, losses, stats)
            rec["logits"], rec["tokens"] = _serve(
                cfg, _numpy_params(cfg, 7 + seed), _prompt(cfg, 7 + seed))
            out[arch] = rec
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def heads_runs(tmp_path_factory):
    result, procs = start_ranks(
        str(tmp_path_factory.mktemp("gloo") / "store"))
    yield result
    for p in procs:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def one_card():
    return one_card_runs()


@pytest.fixture(scope="module", autouse=True)
def _start_ranks_early(heads_runs, one_card):
    """Start the two ranks when the module's first test runs, so that
    they work while the one-card runs and the dry-run cases do."""


# ---------------------------------------------------------------------------
# The dry run: the bf16 attention at the bf16 peak, and the mixer's
# per-device work on a fake (data=2, model=2) mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,kind,factor", [
    (torch.bfloat16, "bfloat16", (4 / 2, 11 / 4)),
    (torch.float32, "float32", (1, 1))])
def test_flash_priced_by_half_products(dtype, kind, factor):
    """bf16 attention runs on tensor cores over exact three-way splits:
    the forward's 2 float32 products take 4 bf16 half-products, the
    backward's 4 (the formula's) take 11 with the recomputed scores;
    float32 inputs run the FFMA route at the float32 peak.  ``flops``
    keeps the formula's count."""
    from repro_torch.kernels.flash_attention import ops  # noqa: F401
    B, S, Hkv, G, D = 1, 64, 2, 2, 32
    meta = lambda *s: torch.empty(s, dtype=dtype, device="meta")  # noqa
    q, k, v = meta(B, S, Hkv, G, D), meta(B, S, Hkv, D), meta(B, S, Hkv, D)
    fwd = 4 * B * S * S * Hkv * G * D
    with tcost.CostMode() as m:
        o, lse = torch.ops.repro_torch.flash_fwd(q, k, v, True, 64, 64, 0)
    assert m.cost.flops == fwd
    assert m.cost.flops_by_dtype == {kind: fwd * factor[0]}
    with tcost.CostMode() as m:
        torch.ops.repro_torch.flash_bwd(o, q, k, v, o, lse, True, 64, 64,
                                        0)
    assert m.cost.flops == 2 * fwd
    assert m.cost.flops_by_dtype == {kind: 2 * fwd * factor[1]}


@pytest.fixture(scope="module")
def fake_four():
    """This process's default group as 4 fake ranks and a (2, 2)
    ``("data", "model")`` mesh over them."""
    from repro_torch.launch.mesh import fake_world, make_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    fake_world(4)
    yield make_mesh((2, 2), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


def _mixer_cost(cfg, kind, mesh=None):
    """Per-device cost of one mixer call (``mamba`` over 64 tokens or
    ``mamba_decode``) at batch 4 on meta tensors, on ``mesh`` under its
    rules or whole."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.ctx import act_rules
    from repro_torch.distributed.sharding import (cache_pspecs,
                                                  distribute_tree)
    from repro_torch.models.mamba import (mamba, mamba_decode,
                                          mamba_init_state, mamba_schema)
    from repro_torch.models.schema import (abstract_params, logical_spec,
                                           make_rules, pspecs)
    schema = mamba_schema(cfg)
    p = abstract_params(schema)
    x = torch.empty(4, 64 if kind == "prefill" else 1, cfg.d_model,
                    device="meta")
    st = mamba_init_state(cfg, 4, device="meta")
    rules = None
    if mesh is not None:
        rules = make_rules(mesh)
        p = distribute_tree(p, mesh, pspecs(schema, rules))
        x = distribute_tree(x, mesh, logical_spec(rules, "batch", None, None,
                                                  dims=x.shape))
        st = {k: v[None] for k, v in st.items()}
        st = distribute_tree(st, mesh, cache_pspecs(st, rules))
        st = {k: v[0] for k, v in st.items()}
    with act_rules(rules), implicit_replication(), tcost.CostMode() as m:
        if kind == "prefill":
            mamba(p, x, cfg)
        else:
            mamba_decode(p, x, cfg, st)
    return m.cost


@pytest.mark.parametrize("arch", TWINS)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dryrun_mixer_work_falls_with_model(fake_four, arch, kind):
    """On (data=2, model=2) each device does about a quarter of the
    mixer's work: its rows and its heads (the conv, the scan, the gate,
    the norm, the step).  Only the B/C conv channels, the norm's mean
    square and the scan's C.B scores, which every head shares, repeat
    across the model axis.  Counted, not timed: the elementwise work is
    0.26-0.31 of the whole, the bytes 0.29-0.39, the matmul FLOPs 0.250-
    0.251 (the projections were already split); with the body split by
    rows alone a device did 0.50-0.53, 0.53-0.62 and 0.259-0.284."""
    cfg = smoke_config(arch)
    whole = _mixer_cost(cfg, kind)
    dev = _mixer_cost(cfg, kind, fake_four)
    assert dev.elem_flops <= 0.35 * whole.elem_flops, (dev, whole)
    assert dev.bytes <= 0.45 * whole.bytes, (dev, whole)
    assert dev.flops <= 0.255 * whole.flops, (dev, whole)


# ---------------------------------------------------------------------------
# The (data=1, model=2) gloo group against the one-card runs
# ---------------------------------------------------------------------------
@pytest.mark.timeout(100)
@pytest.mark.parametrize("arch", TWINS)
def test_body_sees_half_the_heads(heads_runs, arch):
    """Each rank's SSD body sees H/2 heads and di/2 + 2N conv channels,
    in training, prefill and decode alike."""
    cfg = _cfg(arch)
    got = heads_runs()
    for r in range(2):
        assert got[r]["mesh"] == {"data": 1, "model": 2}
        assert got[r][arch]["seen"] == [
            (cfg.ssm_heads // 2, cfg.ssm_inner // 2 + 2 * cfg.ssm_state)]


@pytest.mark.timeout(100)
@pytest.mark.parametrize("arch", TWINS)
def test_two_train_steps_match_one_card(heads_runs, one_card, arch):
    from repro_torch.optim.adamw import lr_at
    got = heads_runs()
    cfg, shape, tc = _train_case(arch)
    want = one_card[arch]
    tol = 2 * sum(float(lr_at(tc.opt, s)) for s in range(TRAIN_RUN["steps"]))
    for r in range(2):
        run = got[r][arch]
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


@pytest.mark.timeout(100)
@pytest.mark.parametrize("arch", TWINS)
def test_prefill_and_decode_match_one_card(heads_runs, one_card, arch):
    got = heads_runs()
    want = one_card[arch]
    top = max(float(np.abs(w).max()) for w in want["logits"])
    for r in range(2):
        run = got[r][arch]
        for a, b in zip(run["logits"], want["logits"]):
            assert float(np.abs(a - b).max()) <= LOGIT_TOL * top, arch
        for a, b in zip(run["tokens"], want["tokens"]):
            np.testing.assert_array_equal(a, b)
