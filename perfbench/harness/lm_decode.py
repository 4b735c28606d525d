"""A mixture-of-experts LM decoding a batch of prompts from
HOBFLOPS-stored weights, through the program's serving steps:
``repro_torch.quant.apply.quantize_params`` over the weights the
benchmark draws, ``repro_torch.serve.steps.make_prefill_step`` in
set-up and greedy ``make_decode_step`` steps in the window, with the
``make_deq`` hook inside a ``perfbench.deq`` span.

Traffic (the mix): ``batch`` prompts whose lengths are the mix's fixed
lognormal quantiles (``inputs.prompt_lengths``) in an order and with
token ids drawn from the seed, left-padded to the longest; the cache
holds the padded prompt and ``gen_positions`` generated tokens.  When it
is full inside the window the next batch of prompts is prefilled, and
that time counts.  Every step's tokens reach the host, and so does the
check's record of the sampled rows' logits: kept in device memory it
would raise ``peak_gb`` with every step the window runs.

After the window, ``check_sequences`` rows of the first batch (drawn
from the seed, the longest prompt among them) are run through the plain
reference (``reference/olmoe.py``) with their prompts and served tokens,
and the numbers the configuration's ``limits`` name are held to them
(``readings``).  Under ``control`` the reference's low-precision forward
takes the program's place in that comparison.
"""
from __future__ import annotations

import contextlib
import gc
import time
import types

import torch

from . import inputs
from .core import Check, Outcome, Run
from .trace import span, traced


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for the configuration file."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        qk_norm=True, rope_theta=cfg["rope_theta"],
        mlp_act=cfg["hidden_act"], moe_experts=cfg["num_experts"],
        moe_top_k=cfg["num_experts_per_tok"],
        moe_capacity_factor=cfg["capacity_factor"],
        norm_eps=cfg["rms_norm_eps"], compute_dtype=cfg["compute_dtype"],
        tie_embeddings=cfg["tie_word_embeddings"])


def sample_rows(lens, k: int, seed: int) -> list[int]:
    """``k`` rows drawn from the seed, the longest prompt's among them."""
    g = inputs.generator("cpu", seed, "check")
    longest = max(range(len(lens)), key=lambda i: lens[i])
    rest = [i for i in torch.randperm(len(lens), generator=g).tolist()
            if i != longest]
    return sorted([longest] + rest[:k - 1])


def run(r: Run) -> Outcome:
    from repro_torch.quant.apply import make_deq, quantize_params
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    cfg, mix, dev = r.cfg, r.mix, r.device
    cuda = dev.type == "cuda"
    mc = model_config(cfg)
    params, _ = quantize_params(inputs.lm_tree(cfg, dev, r.seed), mc,
                                cfg["quant_format"])
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    hook = make_deq()

    def deq(name, x):
        with torch.profiler.record_function("perfbench.deq"):
            return hook(name, x)

    s_pad = max(inputs.prompt_lengths(mix))
    max_len = s_pad + mix["gen_positions"]
    prog = types.SimpleNamespace(
        prefill=make_prefill_step(mc, max_len, deq=deq),
        decode=make_decode_step(mc, deq=deq))
    if r.fault is not None:
        r.fault(prog)
    st = types.SimpleNamespace(wave=-1)
    rec: dict = {}

    def start_wave():
        st.wave += 1
        toks, lens = inputs.prompts(cfg, mix, dev, r.seed, st.wave)
        st.cache = None                 # the full cache goes first
        with span("prefill", r.trace):
            st.cache, last, st.pos = prog.prefill(params, {"tokens": toks})
        st.tok = torch.argmax(last, -1).to(torch.int32)
        if st.wave == 0:
            rows = sample_rows(lens, mix["check_sequences"], r.seed)
            rec.update(prompt=toks, lens=lens, s=st.pos,
                       rows=torch.tensor(rows, device=dev))
            rec["logits"] = [last.index_select(0, rec["rows"]).cpu()]
            rec["served"] = [st.tok.index_select(0, rec["rows"]).cpu()]
        st.tok.cpu()

    def step():
        if st.pos >= max_len:
            start_wave()
        pos = st.pos
        with span("decode", r.trace):
            nxt, logits, st.cache = prog.decode(params, st.tok, pos,
                                                st.cache)
        with span("tokens", r.trace):
            nxt.cpu()                   # the tokens reach the host
        if st.wave == 0:
            rec["logits"].append(logits.index_select(0, rec["rows"]).cpu())
            rec["served"].append(nxt.index_select(0, rec["rows"]).cpu())
        st.tok, st.pos = nxt, pos + 1
        return nxt.shape[0], nxt.shape[0] * (pos + 1)

    start_wave()
    for _ in range(mix["warmup_steps"]):
        step()
    setup_s = time.perf_counter() - r.t0

    t_out: dict = {}
    length = min(r.seconds, mix["trace_seconds"]) if r.trace else r.seconds
    tokens = ctx_sum = steps = 0
    with traced(t_out) if r.trace else contextlib.nullcontext():
        t0 = t1 = time.perf_counter()
        while t1 - t0 < length:
            n, c = step()
            tokens, ctx_sum, steps = tokens + n, ctx_sum + c, steps + 1
            t1 = time.perf_counter()
    window_s = t1 - t0
    peak = mem_peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        mem_peak = max(before, peak)
    del params, prog, st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, ctrl = compare(cfg, rec, dev, r.seed, r.control)
    metrics = {"setup_s": setup_s, "peak_gb": peak / 1e9}
    if tokens:
        metrics["lm_tok_s"] = tokens / window_s
    counters = {"tokens": tokens, "ctx_sum": ctx_sum, "steps": steps,
                "window_s": window_s}
    return Outcome(metrics, counters, checks, tokens, 0, mem_peak,
                   t_out.get("trace"), ctrl if r.control else None)


def readings(ref_logits, logits, served) -> dict:
    """What a run served ([rows, positions]), against the reference's
    logits at the same positions: by how much a served token's logit
    lies below the reference's best (the widest gap, and the mean over
    positions); the share of positions whose served token is not the
    reference's best; the rms logit error over the rms logit, as the
    median over positions and as the largest of the rows' medians."""
    best = ref_logits.max(-1)
    got = ref_logits.gather(-1, served[..., None].long())[..., 0]
    gap = best.values - got
    rms = ref_logits.square().mean(-1).sqrt()
    err = (logits - ref_logits).square().mean(-1).sqrt() / rms
    return {"lm_gap": float(gap.max()), "lm_gap_mean": float(gap.mean()),
            "lm_token_mismatch": float(
                (best.indices != served.long()).float().mean()),
            "lm_logit_rms": float(err.median()),
            "lm_logit_rms_row": float(err.median(-1).values.max())}


def compare(cfg, rec, dev, seed, control: bool):
    from reference.olmoe import Reference

    def leaf(path, layer):
        return inputs.lm_leaf(cfg, path, layer, dev, seed)

    served = torch.stack(rec["served"], 1).to(dev)         # [K, N + 1]
    logits = torch.stack(rec["logits"], 1).to(dev).float()  # [K, N + 1, V]
    rows, s = rec["rows"], rec["s"]
    toks = torch.cat([rec["prompt"].index_select(0, rows),
                      served[:, :-1].long()], 1)
    at = torch.arange(s - 1, toks.shape[1], device=dev)
    lim = cfg["limits"]
    with torch.no_grad():
        ref = Reference(cfg, leaf).forward(toks, s, at)
        got = held = readings(ref, logits, served)
        if control:
            lo = Reference(cfg, leaf, lowp=True).forward(toks, s, at)
            held = readings(ref, lo, lo.argmax(-1))
    checks = [Check(k, held[k], lim[k], held[k] <= lim[k]) for k in lim]
    shown = dict(held, positions=int(served.numel()))
    if control:
        shown.update({k + "_program": v for k, v in got.items()})
    return checks, shown
