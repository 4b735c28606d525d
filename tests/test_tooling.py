"""Tier-1 wiring for the dev tooling: the exhaustive circuit check
script and the machine-readable benchmark emission."""
import json
import os
import sys

import pytest

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))


def test_dev_check_circuits_quick():
    """scripts/dev_check_circuits.py --quick is part of the tier-1 flow."""
    import dev_check_circuits
    assert dev_check_circuits.run_checks(quick=True)


def test_bench_json_writer(tmp_path):
    """run.py's JSON emission produces the BENCH_<section>.json layout
    future PRs read for the perf trajectory."""
    sys.path.insert(0, _ROOT)
    from benchmarks.run import _write_json
    results = {"formats": {"hobflops9": {"rne": {
        "seed_macs_per_s": 1.0, "chain4_macs_per_s": 1.6,
        "speedup_vs_seed": 1.6}}}}
    path = _write_json(str(tmp_path), "macs", results)
    assert os.path.basename(path) == "BENCH_macs.json"
    with open(path) as f:
        assert json.load(f) == results


def test_network_bench_smoke():
    """Tier-1 smoke of the multi-layer pipeline benchmark: a tiny
    bitslice-resident stack (``smoke()``'s) runs and yields the
    BENCH_network.json row layout.  Its bit-exactness against the
    per-layer roundtrip is ``test_network.py``'s, the residual-pool
    graph's ``test_network_graph.py``'s."""
    sys.path.insert(0, _ROOT)
    from benchmarks.network import bench_network
    row = bench_network("hobflops8", hw=6, c=8, depth=3, iters=1, reps=1)
    for key in ("resident_macs_per_s", "roundtrip_macs_per_s",
                "speedup_vs_roundtrip", "macs"):
        assert key in row, row
    assert row["macs"] > 0


def test_serve_bench_smoke():
    """Tier-1 smoke of the lane-batched serve engine: a tiny graph
    serves 5 queued requests (one full wave + a ragged wave),
    bit-exact vs the per-request run, and reports engine stats."""
    sys.path.insert(0, _ROOT)
    from benchmarks.serve import smoke
    st = smoke()
    assert st["waves"] == 2 and st["images_served"] == 5
    assert st["runner_cache"]["misses"] >= 1
    assert 0.0 < st["mean_occupancy"] <= 1.0


def test_gates_chain_table_shape():
    """chain_table reports gates/MAC per lib with the fields the
    acceptance trajectory tracks."""
    sys.path.insert(0, _ROOT)
    from benchmarks.gates import LIBS, chain_table
    rows = chain_table(["hobflops8"], k=2)
    (row,) = rows
    for lib in LIBS:
        cell = row[lib]
        assert cell["chain_gates_per_mac"] < cell["mac_gates"]
        assert cell["saving_pct"] > 0
