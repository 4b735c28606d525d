"""The port's LM serving for the MoE, Mamba-2, hybrid, enc-dec and VLM
families, and its wave-scheduled ``ServeEngine``, against the JAX
package.

Both packages run the same parameters: a tree drawn with numpy from the
reference's schema (its shapes and init rules, ``default_rng`` seeded),
given to the reference as arrays and to the port through
``repro_torch.convert.lm_params_from_jax``; quantized, the reference's
``quantize_params`` tree carried across the same way.  The models are
the smoke twins of olmoe-1b-7b (MoE, qk-norm), mamba2-2.7b (SSD),
jamba-v0.1-52b (Mamba-1-style SSM, attention and MoE in an 8-layer
period), seamless-m4t-medium (encoder, cross-attention) and
internvl2-26b (a projected prefix), with ``ssm_chunk`` 8 so that a
12-token prompt pads and crosses chunks.

Tolerances:
* float32 compute: logits and every cache leaf within ``1e-4 *
  max|value|``, greedy tokens equal (as ``tests/test_torch_lm.py``).
  The two packages run the same float32 operations in another summation
  order (the reference's XLA contractions, cumsums and blockwise
  softmax against the port's torch ones).  Measured: at most 4.4e-6 of
  the largest logit and 4.7e-6 of the largest cache value (jamba's
  twin, eight layers; 0.4e-6 to 0.8e-6 for the others), 4.8e-7 of the
  largest ``moe`` output.
* the SSD scan: ``2e-4`` absolute and relative, the reference's own
  bound for its chunked scan against the sequential recurrence
  (``tests/test_models.py``).
* ``torch.nn.functional.softplus`` returns its input above 20, where
  ``jax.nn.softplus`` computes ``log1p(exp(x))``; the two differ there
  by less than ``exp(-20)``, below float32 resolution at 20.
* bfloat16 compute (``serve_demo``'s default): logits within ``2**-6 *
  max|logit|``, the bound ``tests/test_torch_lm.py`` argues (measured on
  olmoe's twin: 0.0052 of the largest logit).
"""
import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import THREADS

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import decode_step as jdecode_step
from repro.models import forward_logits as jforward_logits
from repro.models import model_schema as jmodel_schema
from repro.models import prefill as jprefill
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models.schema import param_count as jparam_count
from repro.quant import apply as japply
from repro.quant import storage as jstorage
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.serve import serve_demo
from repro_torch.models import (decode_step, forward_logits, model_schema,
                                prefill, transformer)
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models.schema import init_params, param_count
from repro_torch.quant.apply import make_deq, quantize_params
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.steps import make_decode_step, make_prefill_step

FAMILIES = ["olmoe-1b-7b", "mamba2-2.7b", "jamba-v0.1-52b",
            "seamless-m4t-medium", "internvl2-26b"]
CASES = [(a, None) for a in FAMILIES] + [("olmoe-1b-7b", "hobflops9"),
                                         ("mamba2-2.7b", "hobflops9")]
B, S, STEPS = 2, 12, 2
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6
SSD_TOL = 2e-4


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


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, jstorage.QuantizedTensor):
        return (np.asarray(tree.data), np.asarray(tree.scale),
                (tree.sfmt.w_e, tree.sfmt.w_f), tree.layout, tree.shape)
    return np.asarray(tree)


def _cfgs(arch, **over):
    """(reference config, port config): the smoke twin at float32
    compute, chunk 8."""
    over = {"compute_dtype": "float32", "ssm_chunk": 8, **over}
    return (dataclasses.replace(jsmoke_config(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


def _np_batch(cfg, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["prefix"] = rng.standard_normal(
            (B, cfg.num_prefix, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol: float, what: str):
    got = got.to(torch.float32).numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), \
        f"{what}: max err {err} vs {tol} * {np.abs(want).max()}"


def _jax_run(arch, quant):
    """The reference's forward, prefill and two greedy decode steps at
    float32 compute, float32 cache."""
    jcfg, _ = _cfgs(arch)
    params = jax.tree.map(jnp.asarray, _np_params(
        jmodel_schema(jcfg), np.random.default_rng(1)))
    deq = None
    if quant:
        params = jax.jit(lambda p: japply.quantize_params(p, jcfg, quant)[0])(
            params)
        deq = japply.make_deq()
    batch = _np_batch(jcfg, np.random.default_rng(2))
    fwd, aux = jforward_logits(params, batch, jcfg, mode="prefill", deq=deq)
    cache, lg, length = jprefill(params, batch, jcfg,
                                 S + STEPS + jcfg.num_prefix,
                                 dtype=jnp.float32, deq=deq)
    out = {"params": _as_numpy(params), "batch": batch,
           "forward": np.asarray(fwd), "aux": float(aux),
           "length": int(length), "prefill": np.asarray(lg),
           "cache": jax.tree.map(np.asarray, cache), "steps": []}
    step = jax.jit(lambda p, t, c, pos: jdecode_step(p, t, c, pos, jcfg,
                                                     deq=deq))
    for i in range(STEPS):
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        lg, cache = step(params, tok, cache, jnp.int32(length + i))
        out["steps"].append((np.asarray(tok), np.asarray(lg)))
    out["final_cache"] = jax.tree.map(np.asarray, cache)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's runs, in the worker's threads: XLA compiles
    outside the interpreter lock, and compiling is most of their time."""
    with ThreadPoolExecutor(min(4, THREADS)) as pool:
        runs = list(pool.map(lambda case: _jax_run(*case), CASES))
    return dict(zip(CASES, runs))


def _close_cache(got, want, what):
    assert sorted(got) == sorted(want), what
    for key, c in want.items():
        assert sorted(got[key]) == sorted(c), (what, key)
        for name, w in c.items():
            _close(got[key][name], w, F32_TOL, f"{what} {key}/{name}")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(JARCH_IDS))
def test_param_count_matches_reference(arch):
    """Every full config builds its schema (nothing allocated) with the
    reference's parameter count."""
    assert param_count(model_schema(get_config(arch))) == \
        jparam_count(jmodel_schema(jget_config(arch)))


def test_param_counts_of_record():
    """The port knows the reference's ten configs, serves every family
    (no dense-only guard is left), and counts as the papers do."""
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    assert not hasattr(transformer, "require_dense")
    assert [param_count(model_schema(get_config(a))) for a in
            ("olmoe-1b-7b", "mamba2-2.7b", "jamba-v0.1-52b",
             "seamless-m4t-medium")] == \
        [6_920_673_280, 2_703_623_680, 52_385_522_048, 979_433_472]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_moe_matches_reference(arch):
    """The dispatch ``moe`` at the default capacity factor 1.25 on the
    same numpy inputs: olmoe's twin routes every token to all 8 experts
    (top-8 of 8: the routing is the order of the probabilities); jamba's
    routes top-2 of 8 and, at 24 tokens a row, drops tokens past an
    expert's capacity, so which tokens survive follows the stable sort.
    Expert choices are compared first."""
    jcfg, cfg = _cfgs(arch)
    assert cfg.moe_capacity_factor == 1.25
    rng = np.random.default_rng(3)
    p = _np_params(jmoe.moe_schema(jcfg), rng)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)

    k = cfg.moe_top_k
    probs = jax.nn.softmax(x @ p["router"], axis=-1)
    _, want_e = jax.lax.top_k(probs, k)
    _, _, got_e = tmoe.route(tp["router"], tx, k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    counts = np.stack([np.bincount(e.ravel(), minlength=cfg.moe_experts)
                       for e in np.asarray(want_e)])
    dropped = np.maximum(counts - tmoe._capacity(cfg, x.shape[1]), 0).sum()
    assert (dropped > 0) == (arch == "jamba-v0.1-52b")

    want_y, want_aux = jax.jit(lambda p, x: jmoe.moe(p, x, jcfg))(p, x)
    got_y, got_aux = tmoe.moe(tp, tx, cfg)
    _close(got_y, want_y, F32_TOL, "moe y")
    assert got_aux.dtype == torch.float32 and got_aux.ndim == 0
    _close(got_aux, want_aux, F32_TOL, "moe aux")


def test_moe_matches_dense_ref_when_no_drops():
    _, cfg = _cfgs("olmoe-1b-7b", moe_capacity_factor=8.0)
    gen = torch.Generator().manual_seed(0)
    p = init_params(tmoe.moe_schema(cfg), gen, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y, aux = tmoe.moe(p, x, cfg)
    torch.testing.assert_close(y, tmoe.moe_dense_ref(p, x, cfg),
                               rtol=1e-4, atol=1e-5)
    assert float(aux) > 0


# ---------------------------------------------------------------------------
# SSD and the Mamba mixer
# ---------------------------------------------------------------------------
def _ssd_inputs(rng, b, s, h, pd, n):
    return (rng.standard_normal((b, s, h, pd)).astype(np.float32),
            -np.abs(rng.standard_normal((b, s, h))).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


def test_ssd_chunked_matches_reference():
    """S 12 at chunk 8: zero-padded to two chunks.  Then the same
    sequence split at 8 with the state carried in ``h0``."""
    args = _ssd_inputs(np.random.default_rng(4), 2, 12, 3, 4, 8)
    targs = [torch.from_numpy(a) for a in args]
    y, h = tmamba.ssd_chunked(*targs, 8)
    jssd = jax.jit(jmamba.ssd_chunked, static_argnums=4)
    jy, jh = jssd(*args, 8)
    ry, rh = tmamba.ssd_reference(*targs)
    assert ry.dtype == torch.float64
    for got, want in ((y, jy), (h, jh), (y, ry), (h, rh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SSD_TOL, atol=SSD_TOL)

    first = [a[:, :8] for a in targs]
    rest = [a[:, 8:] for a in targs]
    _, h1 = tmamba.ssd_chunked(*first, 8)
    y2, h2 = tmamba.ssd_chunked(*rest, 8, h0=h1)
    jy2, jh2 = jssd(*[a.numpy() for a in rest], 8, h1.numpy())
    ry2, rh2 = tmamba.ssd_reference(*rest, h0=h1)
    for got, want in ((y2, jy2), (h2, jh2), (y2, ry2), (h2, rh2),
                      (y2, y[:, 8:]), (h2, h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SSD_TOL, atol=SSD_TOL)


def test_mamba_decode_after_mamba_matches_reference():
    """``mamba`` over 12 tokens, then ``mamba_decode`` of the 13th from
    its state (float32 conv state): outputs and states against the
    reference's."""
    jcfg, cfg = _cfgs("mamba2-2.7b")
    rng = np.random.default_rng(5)
    p = _np_params(jmamba.mamba_schema(jcfg), rng)
    x = (rng.standard_normal((2, 13, cfg.d_model)) * 0.5).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    jy, jst = jax.jit(lambda p, x: jmamba.mamba(p, x, jcfg))(p, x[:, :12])
    jyd, jst2 = jax.jit(lambda p, x, st: jmamba.mamba_decode(p, x, jcfg, st))(
        p, x[:, 12:], jst)
    y, st = tmamba.mamba(tp, tx[:, :12], cfg)
    yd, st2 = tmamba.mamba_decode(tp, tx[:, 12:], cfg, st)
    _close(y, jy, F32_TOL, "mamba y")
    _close(yd, jyd, F32_TOL, "mamba_decode y")
    for name in ("conv", "ssd"):
        _close(st[name], jst[name], F32_TOL, f"mamba state {name}")
        _close(st2[name], jst2[name], F32_TOL, f"mamba_decode state {name}")


# ---------------------------------------------------------------------------
# The whole model: forward, prefill, greedy decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,quant", CASES)
def test_lm_family_matches_jax_f32(jax_runs, arch, quant):
    run = jax_runs[(arch, quant)]
    _, cfg = _cfgs(arch)
    params = lm_params_from_jax(run["params"], device="cpu")
    deq = make_deq() if quant else None
    batch = _torch_batch(run["batch"])
    fwd, aux = forward_logits(params, batch, cfg, deq=deq)
    _close(fwd, run["forward"], F32_TOL, "forward_logits")
    if cfg.moe_experts:
        _close(aux, run["aux"], F32_TOL, "forward aux")

    cache, lg, length = prefill(params, batch, cfg,
                                S + STEPS + cfg.num_prefix,
                                dtype=torch.float32, deq=deq)
    assert length == run["length"] == S + cfg.num_prefix
    _close(lg, run["prefill"], F32_TOL, "prefill logits")
    _close_cache(cache, run["cache"], "prefill cache")
    for i, (want_tok, want_lg) in enumerate(run["steps"]):
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), want_tok)
        lg, cache = decode_step(params, tok, cache, length + i, cfg,
                                deq=deq)
        _close(lg, want_lg, F32_TOL, f"decode step {i}")
    np.testing.assert_array_equal(
        torch.argmax(lg, dim=-1).numpy(),
        np.argmax(run["steps"][-1][1], axis=-1))
    _close_cache(cache, run["final_cache"], "decoded cache")
    assert cache[next(iter(cache))].get("ssd", torch.zeros(())).dtype == \
        torch.float32


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------
# Prompt lengths and budgets of the scripted queue: at three slots the
# two waves both pad to 12 tokens (one prefill shape for the reference's
# jit), with shorter prompts left-padded inside each.
QUEUE = [(7, 5), (12, 3), (3, 4), (9, 2), (12, 5)]
EOS_AT = 2          # the request that stops at an EOS


def _queue(cfg, eos_id=None, request=Request):
    rng = np.random.default_rng(6)
    return [request(i, rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=m, eos_id=eos_id if i == EOS_AT else None)
            for i, (n, m) in enumerate(QUEUE)]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert [r.rid for r in done] == [r.rid for r in reqs]
    assert all(r.done for r in done)
    return ([r.out for r in done], engine.total_decode_steps,
            engine.total_tokens)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_engine_queue_matches_reference(arch):
    """One scripted queue (mixed prompt lengths and budgets, request
    ``EOS_AT`` given its own second token as EOS) through both engines
    at float32: token lists and both counters equal."""
    jcfg, cfg = _cfgs(arch)
    np_params = _np_params(jmodel_schema(jcfg), np.random.default_rng(7))
    params = lm_params_from_jax(np_params, device="cpu")

    def port_engine():
        return ServeEngine(cfg, params, n_slots=3, max_len=32)

    probe, _, _ = _serve(port_engine(), _queue(cfg))
    eos = probe[EOS_AT][1]
    got = _serve(port_engine(), _queue(cfg, eos))
    want = _serve(JServeEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                               n_slots=3, max_len=32),
                  _queue(jcfg, eos, JRequest))
    assert got == want
    outs = got[0]
    assert len(outs[EOS_AT]) < QUEUE[EOS_AT][1] and outs[EOS_AT][-1] == eos
    assert [len(o) for i, o in enumerate(outs) if i != EOS_AT] == \
        [m for i, (_, m) in enumerate(QUEUE) if i != EOS_AT]


def test_engine_single_slot_matches_plain_loop():
    """A batch-of-1 wave equals the plain serve loop token for token."""
    cfg = smoke_config("qwen2-0.5b")
    params = init_params(model_schema(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    eng = ServeEngine(cfg, params, n_slots=1, max_len=64)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, 10)
    req = Request(0, prompt.astype(np.int32), max_new=6)
    eng.submit(req)
    eng.run()

    pf = make_prefill_step(cfg, 64)
    st = make_decode_step(cfg)
    cache, lg, length = pf(params, {"tokens": torch.from_numpy(prompt)[None]})
    tok = torch.argmax(lg, -1).to(torch.int32)
    toks = [int(tok[0])]
    for i in range(5):
        tok, _, cache = st(params, tok, length + i, cache)
        toks.append(int(tok[0]))
    assert req.out == toks
    assert eng.total_decode_steps == 5 and eng.total_tokens == 5


def test_engine_quantized_weights():
    cfg = smoke_config("qwen2-0.5b")
    params = init_params(model_schema(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    qparams, deq = quantize_params(params, cfg, "hobflops9")
    eng = ServeEngine(cfg, qparams, n_slots=3, max_len=64, deq=deq)
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, cfg.vocab, 6).astype(np.int32),
                    max_new=3) for i in range(2)]
    outs, steps, tokens = _serve(eng, reqs)
    assert [len(o) for o in outs] == [3, 3] and (steps, tokens) == (2, 4)


def test_engine_refuses_encdec():
    jcfg, cfg = _cfgs("seamless-m4t-medium")
    with pytest.raises(AssertionError, match="decoder-only"):
        JServeEngine(jcfg, {})
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(cfg, {})


# ---------------------------------------------------------------------------
# serve_demo at the default bfloat16 compute
# ---------------------------------------------------------------------------
def test_serve_demo_moe_matches_jax_bf16():
    """``serve_demo`` on olmoe's twin at bfloat16 compute and cache
    against the reference's prefill and greedy decode steps on the same
    parameters and prompt."""
    batch, prompt_len, gen_len = 2, 8, 4
    jcfg = jsmoke_config("olmoe-1b-7b")
    assert jcfg.compute_dtype == "bfloat16"
    np_params = _np_params(jmodel_schema(jcfg), np.random.default_rng(8))
    jparams = jax.tree.map(jnp.asarray, np_params)
    prompt = np.random.default_rng(9).integers(
        0, jcfg.vocab, (batch, prompt_len)).astype(np.int32)
    cache, lg, length = jprefill(jparams, {"tokens": prompt}, jcfg,
                                 prompt_len + gen_len)
    step = jax.jit(lambda p, t, c, pos: jdecode_step(p, t, c, pos, jcfg))
    want_lg, want = [np.asarray(lg)], [np.argmax(np.asarray(lg), -1)]
    for i in range(gen_len - 1):
        lg, cache = step(jparams, jnp.asarray(want[-1], jnp.int32), cache,
                         jnp.int32(length + i))
        want_lg.append(np.asarray(lg))
        want.append(np.argmax(want_lg[-1], -1))

    stats = {}
    got = serve_demo(smoke_config("olmoe-1b-7b"), batch=batch,
                     prompt_len=prompt_len, gen_len=gen_len, device="cpu",
                     print_fn=lambda *_: None,
                     params=lm_params_from_jax(np_params, "cpu"),
                     prompt=torch.from_numpy(prompt).long(), stats=stats)
    np.testing.assert_array_equal(got, np.stack(want, 1))
    assert stats["logits"].shape == (gen_len, batch, jcfg.vocab_padded)
    _close(stats["logits"], np.stack(want_lg), BF16_TOL, "serve logits")
