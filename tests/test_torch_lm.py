"""The port's dense LM stack and serving path against the JAX package.

Both packages run the same parameters: the reference's ``init_params``
tree (and, quantized, its ``quantize_params`` tree) carried across with
``repro_torch.convert.lm_params_from_jax``.  The models are the smoke
twins of qwen2-0.5b (QKV bias, tied embeddings) and qwen3-4b (adds
``qk_norm`` and a set ``d_head``).

Tolerances:
* float32 compute: logits within ``1e-4 * max|logit|`` and greedy tokens
  equal.  The two packages run the same float32 operations; they differ
  only in summation order and in the last bit of ``exp``/``pow``/``cos``.
* bfloat16 compute (the configs' default, ``serve_demo``): every matmul
  output and residual add rounds to bf16 (8 significant bits), and the
  two packages' CPU matmuls round at different points, so a hidden value
  may differ by a bf16 step, ``2**-8`` relative, and the tied logits
  carry that difference (measured: 0.0035 of the largest logit); a few
  such steps over two layers bound it: logits within ``2**-6 *
  max|logit|``, and greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.launch.serve import serve_demo as jserve_demo
from repro.models import decode_step as jdecode_step
from repro.models import forward_logits as jforward_logits
from repro.models import model_schema as jmodel_schema
from repro.models import prefill as jprefill
from repro.models.schema import init_params as jinit_params
from repro.models.schema import param_count as jparam_count
from repro.quant import apply as japply
from repro.quant import storage as jstorage
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.serve import serve_demo
from repro_torch.models import (decode_step, forward_logits, model_schema,
                                prefill)
from repro_torch.models.schema import init_params, param_count
from repro_torch.quant.apply import make_deq

ARCHS = ["qwen2-0.5b", "qwen3-4b"]
QUANTS = [None, "hobflops9"]
B, S, STEPS = 2, 12, 3
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, jstorage.QuantizedTensor):
        return (np.asarray(tree.data), np.asarray(tree.scale),
                (tree.sfmt.w_e, tree.sfmt.w_f), tree.layout, tree.shape)
    return np.asarray(tree)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _jax_run(arch, quant):
    """The reference's forward, prefill and three greedy decode steps at
    float32 compute, float32 cache."""
    jcfg = _f32(jsmoke_config(arch))
    params = jinit_params(jmodel_schema(jcfg), jax.random.PRNGKey(1))
    deq = None
    if quant:
        params, deq = japply.quantize_params(params, jcfg, quant)
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    fwd, _ = jforward_logits(params, {"tokens": tokens}, jcfg,
                             mode="prefill", deq=deq)
    cache, lg, length = jprefill(params, {"tokens": tokens}, jcfg,
                                 S + STEPS, dtype=jnp.float32, deq=deq)
    out = {"params": _as_numpy(params), "tokens": tokens,
           "forward": np.asarray(fwd), "length": int(length),
           "prefill": np.asarray(lg),
           "cache": jax.tree.map(np.asarray, cache), "steps": []}
    step = jax.jit(lambda p, t, c, pos: jdecode_step(p, t, c, pos, jcfg,
                                                     deq=deq))
    for i in range(STEPS):
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        lg, cache = step(params, tok, cache, jnp.int32(length + i))
        out["steps"].append((np.asarray(tok), np.asarray(lg)))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return {(a, q): _jax_run(a, q) for a in ARCHS for q in QUANTS}


def _close(got: torch.Tensor, want: np.ndarray, tol: float, what: str):
    got = got.to(torch.float32).numpy()
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), \
        f"{what}: max err {err} vs {tol} * {np.abs(want).max()}"


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_jax_f32(jax_runs, arch, quant):
    run = jax_runs[(arch, quant)]
    cfg = _f32(smoke_config(arch))
    params = lm_params_from_jax(run["params"], device="cpu")
    deq = make_deq() if quant else None
    batch = {"tokens": torch.from_numpy(run["tokens"]).long()}
    fwd, aux = forward_logits(params, batch, cfg, deq=deq)
    assert aux == 0.0
    _close(fwd, run["forward"], F32_TOL, "forward_logits")

    cache, lg, length = prefill(params, batch, cfg, S + STEPS,
                                dtype=torch.float32, deq=deq)
    assert length == run["length"] == S
    _close(lg, run["prefill"], F32_TOL, "prefill logits")
    for key, c in run["cache"].items():
        for name, want in c.items():
            _close(cache[key][name], want, F32_TOL, f"cache {key}/{name}")
    for i, (want_tok, want_lg) in enumerate(run["steps"]):
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), want_tok)
        lg, cache = decode_step(params, tok, cache, length + i, cfg,
                                deq=deq)
        _close(lg, want_lg, F32_TOL, f"decode step {i}")
    np.testing.assert_array_equal(
        torch.argmax(lg, dim=-1).numpy(),
        np.argmax(run["steps"][-1][1], axis=-1))


@pytest.mark.parametrize("quant", QUANTS)
def test_serve_demo_matches_jax_bf16(quant):
    """``serve_demo`` at the default bf16 compute on the qwen2 smoke
    twin: the reference's parameters and prompt (both from
    ``PRNGKey(seed)``, as its ``serve_demo`` makes them) go into the
    port's ``serve_demo``."""
    seed, batch, prompt_len, gen_len = 0, 2, 8, 4
    jcfg = jsmoke_config("qwen2-0.5b")
    key = jax.random.PRNGKey(seed)
    jparams = jinit_params(jmodel_schema(jcfg), key)
    prompt = np.asarray(jax.random.randint(key, (batch, prompt_len), 0,
                                           jcfg.vocab))
    want = jserve_demo(jcfg, batch=batch, prompt_len=prompt_len,
                       gen_len=gen_len, quant=quant, seed=seed,
                       print_fn=lambda *_: None)

    stats = {}
    got = serve_demo(smoke_config("qwen2-0.5b"), batch=batch,
                     prompt_len=prompt_len, gen_len=gen_len, quant=quant,
                     device="cpu", print_fn=lambda *_: None,
                     params=lm_params_from_jax(_as_numpy(jparams), "cpu"),
                     prompt=torch.tensor(prompt), stats=stats)
    assert got.shape == want.shape == (batch, gen_len)
    np.testing.assert_array_equal(got, want)

    # The reference's logits along the same tokens.
    qparams, deq = (japply.quantize_params(jparams, jcfg, quant) if quant
                    else (jparams, None))
    cache, lg, length = jprefill(qparams, {"tokens": prompt}, jcfg,
                                 prompt_len + gen_len, deq=deq)
    want_lg = [np.asarray(lg)]
    step = jax.jit(lambda p, t, c, pos: jdecode_step(p, t, c, pos, jcfg,
                                                     deq=deq))
    for i in range(gen_len - 1):
        lg, cache = step(qparams, jnp.asarray(want[:, i]), cache,
                         jnp.int32(length + i))
        want_lg.append(np.asarray(lg))
    assert stats["logits"].shape == (gen_len, batch, jcfg.vocab_padded)
    _close(stats["logits"], np.stack(want_lg), BF16_TOL, "serve logits")
    assert stats["prefill_ms"] > 0 and stats["tok_s"] > 0
    if quant:
        assert stats["quantized_bytes"] == japply.quantized_bytes(
            japply.quantize_params(jparams, jcfg, quant)[0])


def test_param_count_and_init_match_reference_schema():
    """qwen2-0.5b at full width has the reference's 494,147,456
    parameters; the smoke twin's init draws the reference's shapes."""
    assert param_count(model_schema(get_config("qwen2-0.5b"))) == \
        jparam_count(jmodel_schema(jget_config("qwen2-0.5b"))) == 494147456
    cfg = smoke_config("qwen3-4b")
    got = init_params(model_schema(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    want = jax.eval_shape(lambda: jinit_params(
        jmodel_schema(jsmoke_config("qwen3-4b")), jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda s: tuple(s.shape), want)

    def check(g, w):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                check(g[k], w[k])
        else:
            assert tuple(g.shape) == w and g.dtype == torch.float32
    check(got, shapes)
    again = init_params(model_schema(cfg), torch.Generator().manual_seed(0),
                        "cpu")
    assert torch.equal(again["embed"]["table"], got["embed"]["table"])


def test_serve_demo_default_device_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_demo(smoke_config("qwen2-0.5b"), print_fn=lambda *_: None)
