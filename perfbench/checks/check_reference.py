"""The plain references against the program's CPU path at smoke sizes:
the frozen softfloat copy against ``repro_torch.core.softfloat``'s
oracle over every canonical code pair, the conv stack against
``NetworkGraph.run`` bit for bit, the storage codec against
``quantize``/``dequantize`` bit for bit, the OLMoE forward against the
program's prefill and decode at float32 compute, and the frozen counts
against the program's own.

    python -m pytest -q perfbench/checks/check_reference.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src"), str(BENCH / "checks")]

import tiny  # noqa: E402
from counts import conv as conv_counts  # noqa: E402
from counts import lm as lm_counts  # noqa: E402
from harness import core, inputs, lm_decode  # noqa: E402
from reference import conv as ref_conv  # noqa: E402
from reference import olmoe  # noqa: E402
from reference import softfloat as sf  # noqa: E402

from repro_torch.core import softfloat as psf  # noqa: E402
from repro_torch.core.fpformat import (FPFormat,  # noqa: E402
                                       StorageFormat)


def canonical(f: sf.Fmt) -> np.ndarray:
    """Every canonical code of ``f``: both zeros, infinities, NaN and
    every normal."""
    normals = [(1 << (f.w_e + f.w_f + 1)) | (s << (f.w_e + f.w_f))
               | (e << f.w_f) | m for s in (0, 1)
               for e in range(1 << f.w_e) for m in range(1 << f.w_f)]
    top = f.w_e + f.w_f + 1
    return np.array(normals + [0, 1 << (f.w_e + f.w_f), 2 << top,
                               (2 << top) | (1 << (f.w_e + f.w_f)),
                               3 << top], np.int64)


@pytest.mark.parametrize("name", ["hobflops8", "hobflops9"])
def test_softfloat_against_the_oracle(name):
    f = sf.fmt_named(name)
    pf = FPFormat(f.w_e, f.w_f)
    a = canonical(f)
    x, y = np.meshgrid(a, a, indexing="ij")
    x, y = x.ravel(), y.ravel()
    tx, ty = torch.as_tensor(x).int(), torch.as_tensor(y).int()
    got = sf.mul(tx, ty, f, f.acc()).numpy()
    want = psf.fp_mul(x, y, pf, pf.mult_out())
    assert (got == want).all()
    acc = canonical(f.acc())
    x, y = np.meshgrid(acc, acc, indexing="ij")
    x, y = x.ravel(), y.ravel()
    got = sf.add(torch.as_tensor(x).int(), torch.as_tensor(y).int(),
                 f.acc()).numpy()
    assert (got == psf.fp_add(x, y, pf.mult_out())).all()
    got = sf.cast(torch.as_tensor(acc).int(), f.acc(), f).numpy()
    assert (got == psf.fp_cast(acc, pf.mult_out(), pf)).all()
    assert (sf.relu(torch.as_tensor(acc).int(), f.acc()).numpy()
            == psf.fp_relu(acc, pf.mult_out())).all()


def test_encode_decode_against_the_codecs():
    f = sf.fmt_named("hobflops9")
    pf = FPFormat(5, 3)
    g = torch.Generator().manual_seed(0)
    x = torch.cat([torch.randn(20000, generator=g) * 10.0 ** k
                   for k in range(-7, 7)]
                  + [torch.tensor([0.0, -0.0, 2.0 ** -15, 2.0 ** -16,
                                   1e-40, -1e-40, 65536.0, 1e9,
                                   float("inf"), float("-inf"),
                                   float("nan")])])
    c = sf.encode_f32(x, f)
    assert torch.equal(c, psf.encode_torch(x, pf))
    assert torch.equal(sf.decode_f32(c, f).view(torch.int32),
                       psf.decode_torch(c, pf).view(torch.int32))
    assert torch.equal(sf.decode_f32(c, f.acc()).view(torch.int32),
                       psf.decode_torch(c, pf.mult_out()).view(torch.int32))


def test_conv_stack_against_network_graph():
    _, cfg, _ = tiny.conv_cell()
    from harness import conv_serve
    eng, kernels = conv_serve.build(cfg, torch.device("cpu"), 5, False)
    imgs = inputs.image_pool(3, cfg["input_hwc"], "cpu", 5)
    got = eng.graph.run(imgs.numpy())
    want = ref_conv.stack_forward(imgs, kernels, cfg["layers"],
                                  sf.fmt_named(cfg["format"]))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert conv_counts.macs_per_image(cfg) == eng.macs_per_image


def test_conv_lookup_against_the_chain():
    """The tables' MAC chain equals the functions' on every kind of code
    word (zero, normal, infinity, NaN, non-canonical fields)."""
    f = sf.fmt_named("hobflops9")
    g = torch.Generator().manual_seed(11)
    x = torch.randint(0, 1 << ref_conv.code_bits(f), (2, 4, 5, 6),
                      generator=g, dtype=torch.int32)
    w = torch.randint(0, 1 << ref_conv.code_bits(f), (3, 3, 6, 7),
                      generator=g, dtype=torch.int32)
    for relu in (False, True):
        got = ref_conv.conv_codes(x, w, f, relu=relu)
        want = ref_conv.conv_codes(x, w, f, relu=relu, lookup=False)
        assert torch.equal(got, want)


def test_conv_counts_of_the_cell():
    _, cfg, _ = core.cell(core.manifest(), "conv-h9.closed128")
    assert conv_counts.macs_per_image(cfg) == 565_182_464
    ops = conv_counts.logic_ops(cfg, 64)
    assert ops == pytest.approx(565_182_464 * 64 * 1427 / 128)
    assert conv_counts.fused_mac_bound_s(cfg, 64) == pytest.approx(
        ops / 16.72704e12)


def test_storage_codec_against_quantize():
    from repro_torch.quant.storage import dequantize, quantize
    g = torch.Generator().manual_seed(1)
    for w in (torch.randn(64, 96, generator=g) * 0.02,
              torch.randn(4096, generator=g) * torch.logspace(
                  -30, 3, 4096),
              torch.tensor([0.0, -0.0, 1e-40, 3.0, -3.0, 3.0 * 2 ** -30])):
        q = dequantize(quantize(w, StorageFormat(5, 3), layout="bitplane"))
        assert torch.equal(olmoe.quantized(w, 5, 3).view(torch.int32),
                           q.view(torch.int32))


def test_capacity_against_the_program():
    from repro_torch.models.moe import _capacity
    _, cfg, _ = core.cell(core.manifest(), "olmoe-h9.decode32")
    mc = lm_decode.model_config(cfg)
    for t in (1, 2, 7, 64, 100, 256, 1000, 1024, 4096):
        assert olmoe.capacity(cfg, t) == _capacity(mc, t)


def test_lm_counts_against_the_schema():
    from repro_torch.models import model_schema
    from repro_torch.models.schema import _leaves
    _, cfg, _ = core.cell(core.manifest(), "olmoe-h9.decode32")
    assert lm_counts.active_params(cfg) == 1_178_861_568
    shapes = sorted(tuple(p.shape) for p in
                    _leaves(model_schema(lm_decode.model_config(cfg))))
    n = cfg["num_hidden_layers"]
    ours = sorted(((n,) + s) if st else s
                  for _, s, st, _ in inputs.lm_leaves(cfg))
    assert shapes == ours


def test_olmoe_forward_against_prefill_and_decode():
    """At float32 compute and a float32 cache the program's prefill and
    decode give the reference's logits: the same model, routing and
    capacity drops."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.quant.apply import make_deq, quantize_params
    _, cfg, mix = tiny.lm_cell()
    cfg = dict(cfg, compute_dtype="float32")
    mix = dict(mix, prompt_median=40, prompt_min=24, prompt_max=64)
    mc = lm_decode.model_config(cfg)
    seed = 11
    params, _ = quantize_params(inputs.lm_tree(cfg, "cpu", seed), mc,
                                cfg["quant_format"])
    toks, lens = inputs.prompts(cfg, mix, "cpu", seed)
    s = toks.shape[1]
    steps = 5
    deq = make_deq()
    cache, last, pos = prefill(params, {"tokens": toks}, mc, s + steps,
                               dtype=torch.float32, deq=deq)
    tok = last.argmax(-1).int()
    got, served = [last], [tok]
    for _ in range(steps):
        lg, cache = decode_step(params, tok, cache, pos, mc, deq=deq)
        tok = lg.argmax(-1).int()
        pos += 1
        got.append(lg)
        served.append(tok)
    got = torch.stack(got, 1)
    served = torch.stack(served, 1)
    seq = torch.cat([toks, served[:, :-1].long()], 1)
    ref = olmoe.Reference(
        cfg, lambda p, i: inputs.lm_leaf(cfg, p, i, "cpu", seed)).forward(
        seq, s, torch.arange(s - 1, seq.shape[1]))
    err = (got - ref).abs().max() / ref.abs().max()
    assert err < 1e-5, err
    # some prompt tokens were dropped at prefill, none at decode
    assert olmoe.capacity(cfg, s) < s * cfg["num_experts_per_tok"]


def test_prompts_and_draws_repeat():
    _, cfg, mix = tiny.lm_cell()
    a, la = inputs.prompts(cfg, mix, "cpu", 2 ** 33 + 5)
    b, lb = inputs.prompts(cfg, mix, "cpu", 2 ** 33 + 5)
    c, lc = inputs.prompts(cfg, mix, "cpu", 2 ** 33 + 6)
    assert torch.equal(a, b) and la == lb
    assert sorted(la) == sorted(lc) and not torch.equal(a, c)
    t0 = time.perf_counter()
    x = inputs.lm_leaf(cfg, ("blocks", "b0", "moe", "w_up"), 1, "cpu", -3)
    y = inputs.lm_leaf(cfg, ("blocks", "b0", "moe", "w_up"), 1, "cpu", -3)
    assert torch.equal(x, y) and time.perf_counter() - t0 < 10
