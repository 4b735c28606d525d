import os
import signal
import sys

# One thread budget per xdist worker, set before jax or torch is
# imported: each of W workers gets cpu_count // W threads, so that the
# workers' (and their spawned gloo ranks' and subprocesses') torch,
# OpenMP, MKL/OpenBLAS and XLA pools do not each size themselves for
# the whole machine and spin against each other.  A run in one process
# (no -n, as `pytest -m gpu` on the card) keeps the defaults.
CPUS = os.cpu_count() or 1
THREADS = max(1, CPUS // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                            "1")))
if THREADS < CPUS:
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
    os.environ.setdefault("MKL_NUM_THREADS", str(THREADS))
    # XLA's CPU pool cannot be sized from XLA_FLAGS, only kept off the
    # Eigen ops; this changes no device count.
    os.environ["XLA_FLAGS"] = " ".join(
        filter(None, [os.environ.get("XLA_FLAGS"),
                      "--xla_cpu_multi_thread_eigen=false"]))
    import torch
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)

import pytest  # noqa: E402

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
    config.addinivalue_line(
        "markers", "slow: over 60 s alone; deselected unless asked for "
                   "(run: pytest -m slow)")
    config.addinivalue_line(
        "markers", "timeout(seconds): fails the test with its stack once "
                   "its call runs longer (run: any pytest command)")


def pytest_collection_modifyitems(config, items):
    """Deselects the ``slow`` tests unless the -m expression names
    them."""
    if "slow" in (config.getoption("markexpr") or ""):
        return
    slow = [it for it in items if it.get_closest_marker("slow")]
    if slow:
        config.hook.pytest_deselected(items=slow)
        items[:] = [it for it in items
                    if not it.get_closest_marker("slow")]


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    """Fails a test marked ``timeout(seconds)`` with its stack when its
    call runs longer: SIGALRM raises in the test's own frame."""
    mark = item.get_closest_marker("timeout")
    if mark is None:
        return (yield)
    seconds = mark.args[0]

    def expire(signum, frame):
        pytest.fail(f"timeout: over {seconds} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
