"""Runner and autotune caches for the lane-batched serve engine.

Two cold-start costs dominate a fresh HOBFLOPS serving process: building
the graph's kernels (one ``nvcc`` call for every fused variant the
graph launches) and the ``tune_conv_blocks`` sweep (dozens of timed
launches).  Both are pure functions of static structure, so both cache:

* :class:`RunnerCache` — wave runners keyed by
  ``(graph signature, input HxWxC, batch bucket, precision plan)``.
  Wave sizes are rounded up to power-of-two *buckets* (1/2/4/...), so
  the runner count is bounded by the bucket ladder whatever the traffic
  mix; the tail of a ragged final wave rides as zero-image pad.  A
  runner is built by :func:`build_runner`: the graph's kernels
  (``repro_torch.kernels.build_kernels``), then its resident entrypoint
  (``NetworkGraph.resident_runner``) behind the copy of the packed wave
  to the graph's device, with the bucket's shape validated through
  ``shape_plan`` exactly once, on miss.  A kernel that fails to build
  is a runner-build failure, retried and evicted like any other.
* Tune persistence — ``tuned_conv_blocks`` wraps ``tune_conv_blocks``
  with a JSON disk cache keyed by the problem signature (shapes,
  kernel geometry, format, stride/padding, backend, device type), so
  repeat processes skip the sweep entirely.  The path defaults to
  ``.hobflops_tune_torch.json`` in the working directory and is
  overridden by the ``HOBFLOPS_TORCH_TUNE_CACHE`` environment variable
  or an explicit argument — never the JAX package's file or variable,
  whose winners were timed on another device.
"""
from __future__ import annotations

import json
import os
import warnings

import torch

from repro_torch._build import resolve_device
from repro_torch.kernels.conv2d_bitslice.network import NetworkGraph
from repro_torch.kernels.conv2d_bitslice.ops import (ConvWeights,
                                                     tune_conv_blocks)

TUNE_CACHE_ENV = "HOBFLOPS_TORCH_TUNE_CACHE"
_TUNE_CACHE_DEFAULT = ".hobflops_tune_torch.json"


# ---------------------------------------------------------------------------
# Batch buckets
# ---------------------------------------------------------------------------
def bucket_sizes(max_batch: int) -> tuple[int, ...]:
    """The power-of-two bucket ladder up to and including
    ``max_batch`` (itself appended if not a power of two)."""
    assert max_batch >= 1
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def bucket_for(n: int, buckets) -> int:
    """Smallest bucket holding ``n`` images."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} images exceed the largest bucket "
                     f"{max(buckets)}")


# ---------------------------------------------------------------------------
# Runner cache
# ---------------------------------------------------------------------------
def build_kernels_for(graph: NetworkGraph, devices) -> None:
    """Build (or load) the kernels ``graph`` launches on ``devices``, in
    one ``nvcc`` call for every fused variant not yet built; nothing
    when every device is the CPU, where the wrappers run their plain
    versions.  A build failure raises
    :class:`repro_torch._build.KernelBuildError`."""
    if all(torch.device(d).type != "cuda" for d in devices):
        return
    from repro_torch.kernels import build_kernels
    build_kernels(graph.fused_variants() if graph.backend == "cuda_fused"
                  else ())


def build_runner(graph: NetworkGraph):
    """A wave runner ``batch [B,H,W,C] (numpy or tensor) -> [B,Ho,Wo,M]
    f32 tensor on the graph's device``: the graph's kernels built
    (:func:`build_kernels_for`), then its resident entrypoint behind the
    copy of the packed wave to the device.  The result is not
    synchronised; the caller waits for the device."""
    build_kernels_for(graph, [graph.device])
    run, device = graph.resident_runner(), graph.device
    return lambda batch: run(torch.as_tensor(batch, dtype=torch.float32,
                                             device=device))


class RunnerCache:
    """Wave runners keyed by (graph signature, HxWxC, bucket,
    precision plan).

    The port has no jit: a runner is the graph's resident entrypoint
    over kernels built once per process.  This layer exists to (a) make
    the build *policy* explicit — only bucket shapes ever reach a
    runner, so the runner count is bounded by the bucket ladder — and
    (b) count hits/misses/evictions so the engine's stats expose
    cold-start and self-healing behaviour.  One cache may serve several
    engines (or several graphs) at once.  Entries are never evicted for
    capacity (a serving process holds a handful of buckets by
    construction) but the executor evicts an entry whose wave *failed*
    — a corrupted/bad runner can only be cured by rebuild, and the next
    ``get`` re-misses cleanly.
    """

    def __init__(self):
        self._runners: dict[tuple, object] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._runners)

    def keys(self) -> tuple:
        return tuple(self._runners)

    def evict(self, key) -> bool:
        """Drop one cached runner (the executor's bad-runner path);
        True if the key was present."""
        if key in self._runners:
            del self._runners[key]
            self.evictions += 1
            return True
        return False

    def replace(self, key, fn):
        """Swap a cached runner in place — the chaos layer's seam for
        corrupting a live entry (``faults.corrupt_runner_cache``)."""
        assert key in self._runners, key
        self._runners[key] = fn

    def key(self, graph: NetworkGraph, hwc, bucket: int,
            variant: str = "local") -> tuple:
        # The precision plan rides inside signature() (every node's
        # format is part of the hashed structure), so the key needs no
        # second notion of precision identity.
        return (graph.signature(), tuple(hwc), int(bucket), variant)

    def get(self, graph: NetworkGraph, hwc, bucket: int, *,
            build=None, variant: str = "local"):
        """The wave runner for this (graph, geometry, bucket) — built
        (and its bucket shape validated) on miss.  ``build`` overrides
        how the runner is constructed (default :func:`build_runner`; the
        engine passes the sharded build, with a matching ``variant``
        so local and sharded runners never collide)."""
        key = self.key(graph, hwc, bucket, variant)
        fn = self._runners.get(key)
        if fn is None:
            self.misses += 1
            graph.shape_plan((bucket,) + tuple(hwc))
            fn = build() if build is not None else build_runner(graph)
            self._runners[key] = fn
        else:
            self.hits += 1
        return fn


# ---------------------------------------------------------------------------
# tune_conv_blocks persistence
# ---------------------------------------------------------------------------
def tune_cache_path(path: str | None = None) -> str:
    """Explicit argument > ``HOBFLOPS_TORCH_TUNE_CACHE`` env var > cwd
    default."""
    return path or os.environ.get(TUNE_CACHE_ENV) or _TUNE_CACHE_DEFAULT


def load_tune_cache(path: str | None = None) -> dict:
    """Load the tune cache, tolerating a corrupted/truncated file.

    The cache is an *accelerator*, never a correctness input, so a
    file torn by a killed process or a bad disk must degrade to "no
    cache" — warn (so operators see the lost winners), ignore the
    content, and let the next :func:`save_tune_cache` rebuild the file
    atomically (it merges from this loader, so a corrupt file merges
    as empty and is simply replaced wholesale).  A parseable file with
    a non-dict top level is corrupt too.
    """
    p = tune_cache_path(path)
    if not os.path.exists(p):
        return {}
    try:
        with open(p) as f:
            cache = json.load(f)
        if not isinstance(cache, dict):
            raise ValueError(
                f"top-level JSON is {type(cache).__name__}, not object")
    except (OSError, ValueError) as e:   # unreadable/corrupt: retune
        warnings.warn(
            f"tune cache {p!r} is corrupt or unreadable ({e}); "
            f"ignoring it — sweeps will re-run and the next save "
            f"rewrites the file atomically", RuntimeWarning,
            stacklevel=2)
        return {}
    return cache


def save_tune_cache(cache: dict, path: str | None = None) -> str:
    """Merge ``cache`` into the file and replace it atomically: the
    on-disk entries are re-read and merged first (so two processes
    tuning *different* problems don't drop each other's winners — the
    remaining same-key race just rewrites an equivalent winner), and
    the write goes through a temp file + ``os.replace`` so a killed
    process never leaves a torn JSON behind."""
    p = tune_cache_path(path)
    merged = {**load_tune_cache(path), **cache}
    tmp = f"{p}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(merged, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, p)
    return p


def tune_key(images_shape, kernels, fmt, *, backend: str = "cuda_fused",
             device="cuda", candidates=None, **conv_kw) -> str:
    """Problem signature for one tuned conv: everything that affects
    which launch configuration wins — shapes, kernel geometry, format,
    stride/padding, backend, the device type it was timed on, and the
    candidate set searched (a restricted quick sweep must not answer
    for the full default sweep) — and nothing that doesn't (weight
    values, timing iters)."""
    if isinstance(kernels, ConvWeights):
        geom = (kernels.kh, kernels.kw, kernels.cin, kernels.cout)
    else:
        geom = tuple(kernels.shape)
    cand = "default" if candidates is None else sorted(
        repr(tuple(sorted(c.items()))) for c in candidates)
    return repr((tuple(images_shape), geom, (fmt.w_e, fmt.w_f), backend,
                 torch.device(device).type, conv_kw.get("stride", 1),
                 conv_kw.get("padding", "SAME"),
                 conv_kw.get("extended", False), cand))


def tuned_conv_blocks(images, kernels, *, fmt, backend: str = "cuda_fused",
                      device="cuda", path: str | None = None, **tune_kw):
    """``tune_conv_blocks`` on ``device`` with a JSON disk cache.

    The device is resolved first: the default ``"cuda"`` raises on a
    machine without a card, cache hit or not.  On a cache hit the
    stored block dict is returned without running a single candidate (a
    seeded cache is honored verbatim — tests rely on this); on a miss
    the sweep runs and its winner is persisted.  Returns ``(blocks,
    seconds_per_call_or_None)`` — the timing is None on a hit (it was
    measured on some earlier process/machine and is kept only as a
    provenance hint in the file).

    Entries are versioned with the backend they were tuned for.  A
    winner tuned for the netlist-interpreter kernel is not a winner for
    the fused kernel, so an entry written without a backend tag (or
    hand-seeded without one) or tagged for another backend is treated
    as *stale*: it is never reused silently — a warning names the entry
    and the sweep re-runs, overwriting it with a tagged winner.
    """
    device = resolve_device(device)
    key = tune_key(images.shape, kernels, fmt, backend=backend,
                   device=device, candidates=tune_kw.get("candidates"),
                   **{k: v for k, v in tune_kw.items()
                      if k in ("stride", "padding", "extended")})
    hit = load_tune_cache(path).get(key)
    if hit is not None:
        if hit.get("backend") == backend:
            return dict(hit["blocks"]), None
        tag = ("untagged (pre-backend-versioning)"
               if "backend" not in hit
               else f"tuned for backend {hit['backend']!r}")
        warnings.warn(
            f"tune cache entry for this problem is stale — {tag}, but "
            f"backend {backend!r} was requested; retuning instead of "
            f"reusing it (the fresh winner replaces the entry)",
            RuntimeWarning, stacklevel=2)
    best, results = tune_conv_blocks(images, kernels, fmt=fmt,
                                     backend=backend, device=device,
                                     **tune_kw)
    save_tune_cache({key: {"blocks": best, "backend": backend,
                           "seconds_per_call": min(results.values())}},
                    path)
    return best, min(results.values())
