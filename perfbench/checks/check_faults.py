"""A run of each cell's smoke twin on the CPU (the harness's look for a
card left out), sound and with the timed path broken underneath: every
fault the cell can have makes ``correct`` false, as does the control.

Faults: a step that returns its state unchanged (a wave answering with
the previous wave's output; a decode step that leaves the cache as it
was), half of the batch left out (the second half of a wave's images, of
a decode step's rows, answered from the first half), an answer or a
token altered where it is produced.  The exchange between chips does not
exist on one chip.

    python -m pytest -q perfbench/checks/check_faults.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src"), str(BENCH / "checks")]

import tiny  # noqa: E402
from harness import core  # noqa: E402


def run(make, fault=None, control=False, seed=2 ** 32 + 9):
    _, cfg, mix = make()
    r = core.Run(cfg, mix, seed, 0.3, False, torch.device("cpu"),
                 time.perf_counter(), control=control, fault=fault)
    return core.system(cfg["system"]).run(r)


# -- conv: faults planted in the engine's wave executor ------------------
def wrap_wave(eng, change):
    execute = eng.executor.execute
    state = {}

    def broken(graph, hwc, bucket, batch, out_shape, mesh=None):
        out, dt, attempts = execute(graph, hwc, bucket, batch, out_shape,
                                    mesh=mesh)
        return change(out, state), dt, attempts

    eng.executor.execute = broken


def stale_wave(out, state):
    prev = state.get("prev")
    state["prev"] = out.copy()
    return out if prev is None else prev


def half_wave(out, state):
    out = out.copy()
    half = out.shape[0] // 2
    out[half:2 * half] = out[:half]
    return out


def altered_answer(out, state):
    out = out.copy()
    out.view("int32")[0, 0, 0, 0] ^= 1
    return out


def altered_lane(out, state):
    """One bit of the last lane position of every wave."""
    out = out.copy()
    out.view("int32")[-1, 0, 0, 0] ^= 1
    return out


CONV_FAULTS = {"state_unchanged": stale_wave, "half_batch": half_wave,
               "answer_altered": altered_answer, "lane_altered": altered_lane}


def test_conv_sound():
    out = run(tiny.conv_cell)
    assert out.correct, out.checks


@pytest.mark.parametrize("name", sorted(CONV_FAULTS))
def test_conv_fault(name):
    out = run(tiny.conv_cell,
              fault=lambda eng: wrap_wave(eng, CONV_FAULTS[name]))
    assert not out.correct, out.checks


def test_conv_control():
    out = run(tiny.conv_cell, control=True)
    assert not out.correct and out.control["conv_bits_off"] > 0


# -- LM: faults planted in the decode step -------------------------------
def wrap_decode(prog, change):
    decode = prog.decode

    def broken(params, tok, pos, cache):
        return change(decode, params, tok, pos, cache)

    prog.decode = broken


def cache_unchanged(decode, params, tok, pos, cache):
    saved = {k: {n: t.clone() for n, t in c.items()}
             for k, c in cache.items()}
    nxt, logits, cache = decode(params, tok, pos, cache)
    for k, c in cache.items():
        for n, t in c.items():
            t.copy_(saved[k][n])
    return nxt, logits, cache


def half_rows(decode, params, tok, pos, cache):
    nxt, logits, cache = decode(params, tok, pos, cache)
    half = tok.shape[0] // 2
    nxt, logits = nxt.clone(), logits.clone()
    nxt[half:2 * half], logits[half:2 * half] = nxt[:half], logits[:half]
    return nxt, logits, cache


def token_altered(decode, params, tok, pos, cache):
    nxt, logits, cache = decode(params, tok, pos, cache)
    return (nxt + 1) % logits.shape[-1], logits, cache


LM_FAULTS = {"state_unchanged": cache_unchanged, "half_batch": half_rows,
             "token_altered": token_altered}


def test_lm_sound():
    out = run(tiny.lm_cell)
    assert out.correct, out.checks


@pytest.mark.parametrize("name", sorted(LM_FAULTS))
def test_lm_fault(name):
    out = run(tiny.lm_cell,
              fault=lambda prog: wrap_decode(prog, LM_FAULTS[name]))
    assert not out.correct, out.checks


def test_lm_control():
    """The float8 forward in the program's place fails the limits."""
    out = run(tiny.lm_cell, control=True)
    assert not out.correct, out.checks
    assert {c.name for c in out.checks} == set(tiny.lm_cell()[1]["limits"])


def test_conv_open_loop():
    """The generator's open loop (Poisson arrivals with bursts), which a
    later mix file can name: served, correct, latency from the due
    time."""
    def make():
        w, cfg, mix = tiny.conv_cell()
        mix = dict(mix, arrivals="poisson", rate=40.0, burst_every_s=0.2,
                   burst_requests=6)
        return w, cfg, mix
    out = run(make)
    assert out.correct and out.attempted > 0, out.checks
    assert out.metrics["conv_p95_ms"] > 0
