import os
import sys

# Tests run on the real device set (1 CPU device) — the 512-device
# XLA_FLAGS override belongs to launch/dryrun.py ONLY.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def count_primitives(jx, name):
    """Occurrences of primitive ``name`` in a jaxpr, recursing into
    nested jaxprs (pjit bodies, scan/fori carriers).  Shared by the
    one-encode/one-decode invariant tests."""
    n = 0
    for e in jx.eqns:
        if str(e.primitive) == name:
            n += 1
        for p in e.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    n += count_primitives(getattr(inner, "jaxpr", inner),
                                          name)
    return n


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one "
                   "(run: pytest -m gpu tests/test_torch_cuda.py)")
