"""How close ``tests/test_torch_ssm_heads.py``'s (data=1, model=2) runs
come to its bounds, at several seeds.

For each seed (``train_loop``'s seed; the serving parameters and prompt
take numpy seed ``7 + seed``) and each repeat, the two gloo ranks and
the one-card runs of the test module run as the tests run them, and
every compared quantity is printed as its worst error over its bound:
1.0 is the bound, above it the test would fail.  CPU only.

    PYTHONPATH=src python scripts/torch_ssm_heads_margin.py --seeds 0 1 \\
        --repeats 2
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
import test_torch_ssm_heads as t  # noqa: E402


def ratio(a, b, atol, rtol=0.0) -> float:
    """max |a - b| / (atol + rtol |b|); 0 where a equals b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    bound = atol + rtol * np.abs(b)
    return float(np.where(d == 0, 0.0, d / np.where(bound == 0, 1e-300,
                                                    bound)).max())


def margins(run, want, arch) -> dict:
    """The worst error over its bound of each quantity the tests hold,
    and the leaf where the moments' worst lies."""
    from repro_torch.optim.adamw import lr_at
    _, _, tc = t._train_case(arch)
    tol = 2 * sum(float(lr_at(tc.opt, s))
                  for s in range(t.TRAIN_RUN["steps"]))
    out = {k: ratio(run[k], want[k], 0.0, t.METRIC_TOL)
           for k in ("losses", "grad_norm")}
    out["params"] = max(ratio(a, b, tol)
                        for a, b in zip(run["params"], want["params"]))
    for k in ("m", "v"):
        r = [ratio(a, b, 1e-4 * np.abs(b).max(), 1e-3)
             for a, b in zip(run[k], want[k])]
        i = int(np.argmax(r))
        out[k] = r[i]
        out[f"{k}_leaf"] = (i, tuple(want[k][i].shape))
    top = max(float(np.abs(w).max()) for w in want["logits"])
    out["logits"] = max(ratio(a, b, t.LOGIT_TOL * top)
                        for a, b in zip(run["logits"], want["logits"]))
    out["tokens_equal"] = all(np.array_equal(a, b) for a, b in
                              zip(run["tokens"], want["tokens"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    for seed in args.seeds:
        for rep in range(args.repeats):
            with tempfile.TemporaryDirectory() as d:
                result, procs = t.start_ranks(os.path.join(d, "store"), seed)
                try:
                    want = t.one_card_runs(seed)
                    got = result()
                finally:
                    for p in procs:
                        if p.is_alive():
                            p.kill()
            for arch in t.TWINS:
                for r in range(2):
                    m = margins(got[r][arch], want[arch], arch)
                    print(f"seed {seed} repeat {rep} {arch} rank {r}: "
                          + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                                      else f"{k} {v}" for k, v in m.items()),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
