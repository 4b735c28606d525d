"""Model-stack correctness: MoE vs dense reference, SSD vs sequential
recurrence, prefill/decode consistency for every assigned architecture."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCH_NAMES, smoke_config
from repro.models import (decode_step, forward_logits, lm_loss,
                          model_schema, prefill)
from repro.models.mamba import (mamba, mamba_decode, mamba_schema,
                                ssd_chunked, ssd_reference)
from repro.models.moe import moe, moe_dense_ref, moe_schema
from repro.models.schema import init_params, param_count

KEY = jax.random.PRNGKey(0)


def make_batch(cfg, B, S, train=True, key=KEY):
    batch = {"tokens": jax.random.randint(key, (B, S), 0, cfg.vocab)}
    if train:
        batch["labels"] = jax.random.randint(
            jax.random.fold_in(key, 1), (B, S), 0, cfg.vocab)
    if cfg.frontend != "none" and cfg.family != "encdec":
        batch["prefix"] = jax.random.normal(
            key, (B, cfg.num_prefix, cfg.frontend_dim))
    if cfg.family == "encdec":
        batch["frames"] = jax.random.normal(key, (B, S, cfg.frontend_dim))
    return batch


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def test_moe_matches_dense_ref_when_no_drops():
    cfg = dataclasses.replace(smoke_config("olmoe-1b-7b"),
                              moe_capacity_factor=8.0)
    p = init_params(moe_schema(cfg), KEY)
    x = jax.random.normal(KEY, (2, 16, cfg.d_model))
    y, aux = moe(p, x, cfg)
    y_ref = moe_dense_ref(p, x, cfg)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-4, atol=1e-5)
    assert float(aux) > 0


def test_moe_capacity_drops_reduce_output():
    cfg = dataclasses.replace(smoke_config("olmoe-1b-7b"),
                              moe_capacity_factor=0.25)
    p = init_params(moe_schema(cfg), KEY)
    x = jax.random.normal(KEY, (2, 16, cfg.d_model))
    y, _ = moe(p, x, cfg)
    y_full = moe_dense_ref(p, x, cfg)
    # dropped tokens produce zero contribution -> strictly less energy
    assert float(jnp.sum(y ** 2)) < float(jnp.sum(y_full ** 2))
    assert bool(jnp.all(jnp.isfinite(y)))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_vs_sequential(chunk):
    rng = np.random.default_rng(chunk)
    B, S, H, P, N = 2, 48, 3, 4, 8
    xdt = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dA = -np.abs(rng.standard_normal((B, S, H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    y, h = ssd_chunked(jnp.asarray(xdt), jnp.asarray(dA),
                       jnp.asarray(Bm), jnp.asarray(Cm), chunk)
    y_ref, h_ref = ssd_reference(xdt, dA, Bm, Cm)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(h), h_ref, rtol=2e-4, atol=2e-4)


def test_ssd_carried_state():
    """Splitting a sequence and carrying h0 equals one long scan."""
    rng = np.random.default_rng(1)
    B, S, H, P, N = 1, 32, 2, 4, 8
    xdt = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dA = -np.abs(rng.standard_normal((B, S, H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    y_full, h_full = ssd_chunked(xdt, dA, Bm, Cm, 8)
    y1, h1 = ssd_chunked(xdt[:, :16], dA[:, :16], Bm[:, :16],
                         Cm[:, :16], 8)
    y2, h2 = ssd_chunked(xdt[:, 16:], dA[:, 16:], Bm[:, 16:],
                         Cm[:, 16:], 8, h0=h1)
    np.testing.assert_allclose(np.asarray(h2), np.asarray(h_full),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(y2),
                               np.asarray(y_full[:, 16:]),
                               rtol=1e-5, atol=1e-5)


def test_mamba_decode_matches_full():
    cfg = smoke_config("mamba2-2.7b")
    p = init_params(mamba_schema(cfg), KEY)
    x = jax.random.normal(KEY, (2, 33, cfg.d_model)) * 0.5
    y_full, _ = mamba(p, x, cfg)
    _, st = mamba(p, x[:, :32], cfg)
    y_dec, _ = mamba_decode(p, x[:, 32:33], cfg, st)
    np.testing.assert_allclose(np.asarray(y_dec[:, 0]),
                               np.asarray(y_full[:, 32]),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# Per-arch smoke: forward + loss finite, gradients flow
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def arch_params():
    """``init_params(schema, KEY)`` once per arch for both per-arch
    tests: their configurations differ in compute dtype and capacity,
    which leave the schema, and so the parameters, as they are."""
    built = {}

    def params(arch, schema):
        if arch not in built or built[arch][0] != schema:
            built[arch] = (schema, init_params(schema, KEY))
        return built[arch][1]
    return params


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_smoke_train_step(arch, arch_params):
    cfg = smoke_config(arch)
    schema = model_schema(cfg)
    assert param_count(schema) > 0
    params = arch_params(arch, schema)
    batch = make_batch(cfg, 2, 64)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: lm_loss(p, batch, cfg), has_aux=True)(params)
    assert np.isfinite(float(loss))
    gnorm = sum(float(jnp.sum(g ** 2)) for g in jax.tree.leaves(grads))
    assert np.isfinite(gnorm) and gnorm > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_prefill_decode_consistency(arch, arch_params):
    """decode(prefill(S-1)) logits == full-forward logits at position S-1.

    f32 compute isolates *path* equivalence from bf16 noise; the MoE
    capacity factor is raised so token drops can't differ between the
    S-1-token and S-token routing problems."""
    cfg = dataclasses.replace(smoke_config(arch),
                              compute_dtype="float32",
                              moe_capacity_factor=8.0)
    params = arch_params(arch, model_schema(cfg))
    B, S = 2, 32
    batch = make_batch(cfg, B, S, train=False)
    lg_full, _ = forward_logits(params, batch, cfg, mode="prefill")
    pre_batch = dict(batch, tokens=batch["tokens"][:, :S - 1])
    cache, lg_pre, length = prefill(params, pre_batch, cfg,
                                    max_len=S + cfg.num_prefix,
                                    dtype=jnp.float32)
    lg_dec, _ = decode_step(params, batch["tokens"][:, S - 1], cache,
                            jnp.asarray(length, jnp.int32), cfg)
    np.testing.assert_allclose(np.asarray(lg_dec),
                               np.asarray(lg_full[:, -1]),
                               rtol=3e-2, atol=3e-2)
    # prefill's own last-position logits match the full forward too
    np.testing.assert_allclose(np.asarray(lg_pre),
                               np.asarray(lg_full[:, -2]),
                               rtol=3e-2, atol=3e-2)


def test_scan_period_detection():
    jamba = smoke_config("jamba-v0.1-52b")
    assert jamba.scan_period() == 8
    assert smoke_config("llama3-405b").scan_period() == 1
    kinds = jamba.layer_kinds()
    assert sum(1 for a, _ in kinds if a) == jamba.n_layers // 8
