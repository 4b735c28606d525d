"""``BENCHMARK.json`` against the manifest's rules (keys, names, units,
bounds, the budget of a full check) and the files each entry names;
data-only extension (a mix, a configuration, a per-layer metric added
as files and found without an edit); the trace's reduction; the import
guard: the harness's modules, and a run of each cell's smoke twin, leave
no module of JAX or of the JAX package ``repro`` loaded and read nothing
under ``benchmarks/``.

    python -m pytest -q perfbench/checks/check_manifest.py
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from harness import core  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def man():
    return core.manifest()


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(man):
    assert set(man) == KEYS["top"]
    assert len(json.dumps(man)) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = man["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd:
        if (ROOT / w).exists():
            assert any(Path(w).is_relative_to(p) for p in man["paths"]), w
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 2 + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_entries(man):
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        key = {"configs": "config", "workloads": "workload"}.get(kind, kind)
        for e in man[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") \
                else set()
            assert KEYS[key] <= set(e) <= KEYS[key] | extra, e
            assert NAME.match(e["name"]), e["name"]
            if kind in ("end_to_end", "per_layer"):
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher") and e["source"] in SOURCES
            for k in ("why", "layer", "source"):
                if k in e and (k != "source" or kind == "configs"):
                    assert line(e[k]), (e["name"], k)
        names = [e["name"] for e in man[kind]]
        assert len(names) == len(set(names))
    assert 1 <= len(man["configs"]) <= 24
    assert 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128


def test_configs_files_and_cells(man):
    cells = {w["config"] for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        assert c["name"] in cells, f"{c['name']} has no cell"
        assert any(Path(c["file"]).is_relative_to(p) for p in man["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not re.search(r"(_dim|_rank)$|hidden|intermediate|"
                                 r"latent|state|proj|head|expan|per_tok",
                                 k), f"{k} names a width"


def test_workloads(man):
    pairs = set()
    fours = 0
    for w in man["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        fours += w["chips"] == 4
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        _, cfg, mix = core.cell(man, w["name"])
        assert cfg["system"] == mix["system"]
        assert (BENCH / "harness" / f"{cfg['system']}.py").is_file()
    assert fours <= max(1, len(man["workloads"]) // 4)


def test_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in man["workloads"]]
    for m in man["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            assert core.applies(e2e[m["moves"]], c), (m["name"], c)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        got = [m for m in man["end_to_end"] if core.applies(m, c)]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2
        assert any(core.applies(m, c) for m in man["per_layer"])


def test_added_files_are_found_without_an_edit(tmp_path, man):
    """A later change adds a configuration, a mix and a per-layer metric
    as files and entries; the harness finds each by its name."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    new = json.loads(json.dumps(man))
    _, cfg, mix = core.cell(man, "conv-h9.closed128")
    cfg = dict(cfg, name="mobilenet-14x14x512-h9b")
    (root / "perfbench/configs/mobilenet-14x14x512-h9b.json").write_text(
        json.dumps(cfg))
    (root / "perfbench/mixes/open400.json").write_text(json.dumps(
        dict(mix, arrivals="poisson", rate=400.0)))
    (root / "perfbench/metrics/conv.waves.py").write_text(
        "def read(ctx):\n    return ctx.counters.get('waves')\n")
    new["configs"].append(dict(new["configs"][0],
                               name="mobilenet-14x14x512-h9b",
                               file="perfbench/configs/"
                                    "mobilenet-14x14x512-h9b.json"))
    new["workloads"].append({"name": "conv-h9b.open400",
                             "config": "mobilenet-14x14x512-h9b",
                             "traffic": "open400", "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "conv.waves", "unit": "waves",
                             "better": "higher", "source": "program_counter",
                             "layer": "conv serving", "moves":
                             "conv_images_per_s",
                             "workloads": ["conv-h9b.open400"]})
    w, c, m = core.cell(new, "conv-h9b.open400", root=root)
    assert c["name"] == "mobilenet-14x14x512-h9b"
    assert m["arrivals"] == "poisson"
    ctx = core.Context(w["name"], c, m, None, {"waves": 7})
    assert core.per_layer(new, w["name"], ctx,
                          bench=root / "perfbench") == {
        "conv.waves": {"value": 7, "unit": "waves"}}


GUARD = r"""
import json, sys, time
from pathlib import Path
bench = Path(sys.argv[1])
root = bench.parent
opened = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        p = Path(args[0] if isinstance(args[0], str) else args[0].decode())
        opened.append(str(p))
    elif event == "import":
        opened.append(str(args[1] or ""))

sys.addaudithook(hook)
sys.path[:0] = [str(bench), str(root / "src")]
import torch
sys.path.insert(0, str(bench / "checks"))
import tiny
from harness import core
for name in ("conv_serve", "lm_decode", "inputs", "trace"):
    __import__("harness." + name)
import reference.conv, reference.olmoe, counts.conv, counts.lm
man = core.manifest()
for m in man["per_layer"]:
    core.reader(m["name"])
for make in (tiny.conv_cell, tiny.lm_cell):
    w, cfg, mix = make(man)
    run = core.Run(cfg, mix, 3, 0.2, False, torch.device("cpu"),
                   time.perf_counter())
    assert core.system(cfg["system"]).run(run).correct
bad = [p for p in opened if str(root / "benchmarks") in p
       or "BENCH_" in Path(p).name]
print(json.dumps({"forbidden": core.forbidden_modules(), "read": bad}))
"""


def test_no_jax_and_no_benchmarks_folder():
    out = subprocess.run([sys.executable, "-c", GUARD, str(BENCH)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "read": []}


def test_forbidden_names_are_whole_top_level_names():
    assert core.forbidden_modules(["repro_torch", "repro_torch.models",
                                   "jaxtyping", "reproduce"]) == []
    assert core.forbidden_modules(["repro.core", "jax", "jaxlib.xla",
                                   "flax"]) == ["flax", "jax", "jaxlib.xla",
                                                "repro.core"]


def test_trace_reduction():
    """Busy time is the union of device intervals in the window; a span's
    device time is what ran inside its device-side annotation; gaps are
    named after the innermost host event at their middle."""
    from types import SimpleNamespace as NS

    import torch

    from harness import trace
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dt, s, t, ann=False):
        return NS(name=name, device_type=dt, is_user_annotation=ann,
                  time_range=NS(start=s, end=t), cpu_children=[],
                  kernels=[])

    events = [ev(trace.WINDOW_SPAN, cpu, 0, 100),
              ev("perfbench.deq", cpu, 5, 30, True),
              ev("aten::mm", cpu, 50, 60),
              ev("perfbench.deq", cuda, 10, 40, True),
              ev("k1", cuda, 10, 20), ev("k2", cuda, 15, 25),
              ev("k3", cuda, 30, 40), ev("mm", cuda, 60, 90),
              ev("late", cuda, 95, 120)]
    t = trace.reduce(events, 1e-4)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((15 + 10 + 30 + 5) * 1e-6)
    assert t.spans == {"perfbench.deq": pytest.approx(30e-6)}
    assert t.kernels["k1"] == [pytest.approx(10e-6), 1]
    assert [g[0] for g in t.gaps[:2]] == ["aten::mm", "perfbench.deq"]
    assert t.gaps[0][1] == pytest.approx(20e-6)
