"""Build and bind the port's CUDA kernels.

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Libraries land in
``build/kernels/`` at the repository root, named after a hash of the
source text, the flags and the headers under ``csrc/``; a library that
is already there is loaded without compiling.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for all of them.

Pointers and the CUDA stream are passed as ``ctypes.c_void_p``; every C
entry returns ``cudaGetLastError()`` and :func:`check` raises on a
nonzero code.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# Hopper launch defaults of both MAC kernels (see launch_blocks).
# Values never depend on them.  bitslice_mac's three: the lowest sum of
# the stack's batch-1 and batch-4 times in scripts/torch_interp_probe.py's
# sweep (PERF.md).
CHAIN_THREADS = 32         # fused_mac: chains a block, one chain warp
INTERP_CHAINS = 32         # bitslice_mac: chains a block, 8 lanes a pair
FUSED_PRODUCERS = 3        # fused_mac: producer warps a chain warp
INTERP_PRODUCERS = 1       # bitslice_mac: producer warps a chain warp
M_BLOCK = 32               # lane words a block at most: one warp per row
C_BLOCK = 4                # bitslice_mac: channels of a ring slot
FUSED_C_BLOCK = 8          # fused_mac: channels of a ring slot
CHAIN_DEPTH = 4            # MAC steps a chain body is asked to take
MAX_THREADS = 1024         # threads one block may hold
MAX_SMEM = 232448          # bytes of shared memory one block may use


class KernelBuildError(RuntimeError):
    """``nvcc`` failed; the message carries its output."""


class KernelLaunchError(RuntimeError):
    """A C entry returned a nonzero ``cudaError_t``."""


@dataclasses.dataclass
class Library:
    """A loaded kernel library and the ``-Xptxas -v`` report of its
    build (registers, shared memory and spills per kernel)."""
    name: str
    path: Path
    lib: ctypes.CDLL
    ptxas_log: str


_LOADED: dict[Path, Library] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found: the CUDA kernels are built "
                               "on a machine with the CUDA toolkit")
    return path


def _digest(source: str) -> str:
    h = hashlib.sha256(source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def build(jobs: list[tuple[str, str]]) -> list[Library]:
    """Compile and load ``(name, cuda_source)`` pairs, in parallel.

    Sources may ``#include`` the headers in ``csrc/``.  Returns one
    :class:`Library` per job, in order; raises :class:`KernelBuildError`
    with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets, procs = [], []
    for name, source in jobs:
        stem = f"{name}-{_digest(source)}"
        so, log = BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"
        targets.append((name, so, log))
        if so in _LOADED or so.exists():
            procs.append(None)
            continue
        # Written whole and renamed into place, so a process building the
        # same source at the same time never compiles a half-written file.
        cu = BUILD_DIR / f"{stem}.cu"
        cu_tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.cu"
        cu_tmp.write_text(source)
        os.replace(cu_tmp, cu)
        tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(cu)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp))
    errors = []
    for (name, so, log), proc in zip(targets, procs):
        if proc is None:
            continue
        p, tmp = proc
        output, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{name}: nvcc exited {p.returncode}\n{output}")
            continue
        log.write_text(output)
        os.replace(tmp, so)
    if errors:
        raise KernelBuildError("\n".join(errors))
    libs = []
    for name, so, log in targets:
        if so not in _LOADED:
            _LOADED[so] = Library(name, so, ctypes.CDLL(str(so)),
                                  log.read_text() if log.exists() else "")
        libs.append(_LOADED[so])
    return libs


def bind(lib: ctypes.CDLL, symbol: str, argtypes, restype=ctypes.c_int):
    """Look up a C entry and declare its signature."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code}")


def chain_depth(C: int, c_unroll: int | None = None) -> int:
    """The chain depth asked of a kernel for ``C`` channels:
    ``c_unroll`` (default :data:`CHAIN_DEPTH`) clamped to ``[1, C]``."""
    return max(1, min(c_unroll or CHAIN_DEPTH, C))


def launch_blocks(P: int, C: int, Mw: int, *, p_block: int | None = None,
                  m_block: int | None = None, c_block: int | None = None,
                  c_unroll: int | None = None,
                  kernel: str = "bitslice_mac") -> dict:
    """Launch parameters of either MAC kernel for ``P`` rows, ``C``
    channels and ``Mw`` lane words — the one place their defaults live.

    A block covers ``m_block x p_block`` (lane word, row) chains, up to
    :data:`M_BLOCK` lane words, beside producer warps of their own: for
    ``fused_mac`` :data:`CHAIN_THREADS` chains, one chain warp — so a
    batch-1 layer's 98 chain warps land on 98 SMs; for ``bitslice_mac``
    :data:`INTERP_CHAINS` chains, 8 lanes a pair of them.  ``c_block`` channels
    are a ring slot (:data:`C_BLOCK` for ``bitslice_mac``,
    :data:`FUSED_C_BLOCK` for ``fused_mac``).  Given values are kept;
    missing ones take these defaults clamped to the problem.
    ``c_unroll`` is always clamped (:func:`chain_depth`).
    """
    fused = {"bitslice_mac": False, "fused_mac": True}[kernel]
    m = m_block or min(M_BLOCK, Mw)
    chains = CHAIN_THREADS if fused else INTERP_CHAINS
    return {"p_block": p_block or min(max(1, chains // m), P),
            "m_block": m,
            "c_block": c_block or min(FUSED_C_BLOCK if fused else C_BLOCK,
                                      C),
            "c_unroll": chain_depth(C, c_unroll)}


def c_tile(c_block: int, k: int) -> int:
    """The C tile of a launch: ``c_block`` rounded up to a multiple of
    the chain depth ``k``."""
    return -(-max(1, c_block) // k) * k


def check_blocks(p_block: int, m_block: int, ct: int, smem: int,
                 threads: int | None = None, what: str = "") -> None:
    """Raise unless a block over ``m_block x p_block`` chains — of
    ``threads`` threads, by default one a chain — with a C tile of
    ``ct`` channels and ``smem`` bytes of shared memory can launch; a
    refused launch would never run.  ``what`` names a part of the shared
    memory in the message."""
    threads = p_block * m_block if threads is None else threads
    if min(p_block, m_block) < 1 or threads > MAX_THREADS \
            or smem > MAX_SMEM:
        raise ValueError(f"blocks p={p_block} m={m_block} c={ct} need "
                         f"{threads} threads, {smem} B shared"
                         + (f" ({what})" if what else ""))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device on a machine
    without a card raises: entry points never fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           f"is available; pass device='cpu' to run the "
                           f"kernels' plain versions")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize``
    on a CUDA device, nothing on the CPU (whose ops run in order)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous int32 CUDA tensor on
    one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{[str(x.device) for x in tensors]}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"expected contiguous int32, got {t.dtype} "
                             f"contiguous={t.is_contiguous()}")
