"""The fused bitplane-dequant matmul as a CUDA kernel, with its wrapper.

Port of ``repro.kernels.dequant_matmul.kernel.dequant_matmul_pallas``:
weights stay in device memory as HOBFLOPS StorageFormat codes in
``nbits`` bit planes (exactly ``nbits`` bits a weight), and each weight
tile is rebuilt and decoded in shared memory right before the product
consumes it (``csrc/dequant_matmul.cu``; its header note says what
bounds it on the H100).  Two routes, by format (:func:`plan`):

* **tensor cores** (``w_f <= 10``, ``w_e <= 8``): a decoded code is
  exact in TF32, so the codes feed ``wgmma`` as they are, x in two TF32
  halves, and ``scale`` is applied once in the epilogue;
* **f32 FMAs** (``w_f > 10``): the decoded weight times ``scale`` in
  f32 FMA chains over 64x64 output tiles.

Layouts:
    x      : [M, K] float32
    planes : [nbits, K, N/32] int32 (``bitplane2d``)
    scale  : float32 scalar tensor on the device of ``x``
    out    : [M, N] float32
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.core.fpformat import StorageFormat

from .ref import dequant_matmul_ref

LANE = 32
# The tensor-core route's two row classes, named by their narrowest n
# width: TILE_M8 (up to SMALL_M rows: n width 8-64, each block one K
# chunk, a chunk-sum kernel after) and TILE_M64 (more rows: n width 64,
# each block walks every chunk).
TILE_M64, TILE_M8 = 0, 1
# Splitting K pays up to SMALL_M rows.  A layer of qwen2-0.5b's
# projections (2 wq/wo + 2 wk/wv + 2 w_gate/w_up + w_down) takes 0.45-0.49
# of the walked time split at M = 4-64, 0.56 at 128, 0.81 at 256 and 1.15
# at 512 (scripts/torch_dequant_probe.py on an H100 80GB HBM3, 700 W).
SMALL_M = 256
# A decoded code has w_f + 1 significant bits: exact in TF32 (10
# explicit fraction bits) up to w_f = 10.
TC_MAX_WF = 10
# The tensor-core route sums K in chunks of KCHUNK, in chunk order, so
# an output's order of accumulation depends on K alone.
KCHUNK = 256
TC_BN = 64                       # weight columns a block
N_WIDTHS = (8, 16, 32, 64)       # rows of x a block: the least that holds M


def tile_for(M: int) -> int:
    """The row class of a launch over ``M`` rows: ``TILE_M8`` up to
    ``SMALL_M`` rows, else ``TILE_M64``."""
    return TILE_M8 if M <= SMALL_M else TILE_M64


def plan(M: int, K: int, sfmt: StorageFormat) -> dict:
    """How a launch over ``M`` rows and ``K`` terms in ``sfmt`` runs.

    ``route`` is ``"tensor_core"`` for ``w_f <= TC_MAX_WF`` and
    ``w_e <= 8``, else ``"fma"``.  On the tensor core route ``n_width``
    is the rows of x a block takes (the least of ``N_WIDTHS`` that holds
    M, or the widest), ``chunks`` the K chunks of ``KCHUNK``, and
    ``split`` whether each block owns one chunk (``tile_for(M)`` is
    ``TILE_M8``) or walks them all.
    """
    if sfmt.w_f > TC_MAX_WF or sfmt.w_e > 8:
        return {"route": "fma"}
    return {"route": "tensor_core",
            "n_width": next((w for w in N_WIDTHS if w >= M), N_WIDTHS[-1]),
            "chunks": -(-K // KCHUNK), "split": tile_for(M) == TILE_M8}


def build_job() -> tuple[str, str]:
    """The ``(name, source)`` pair :func:`_build.build` compiles."""
    return "dequant_matmul", (_build.CSRC / "dequant_matmul.cu").read_text()


_BOUND: dict = {}


def load(library: _build.Library) -> None:
    """Bind the C entry of a built ``dequant_matmul`` library."""
    vp, ci, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    _BOUND["launch"] = _build.bind(
        library.lib, "dequant_matmul_launch",
        [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, pi, vp])
    _BOUND["tc_launch"] = _build.bind(
        library.lib, "dequant_matmul_tc_launch",
        [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, pi, vp])


def _entry(name: str):
    if name not in _BOUND:
        load(_build.build([build_job()])[0])
    return _BOUND[name]


def launch(x: torch.Tensor, planes: torch.Tensor, scale: torch.Tensor,
           out: torch.Tensor, sfmt: StorageFormat) -> int:
    """Launch the FMA route on checked, contiguous CUDA tensors,
    uncounted; returns the kernels launched (1).  ``chip_smoke.py``
    times the FMA route at the tensor-core route's shapes with it."""
    (M, K), N = x.shape, out.shape[1]
    n = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        code = _entry("launch")(_build.ptr(x), _build.ptr(planes),
                                _build.ptr(scale), _build.ptr(out), M, K, N,
                                sfmt.nbits, sfmt.w_e, sfmt.w_f,
                                ctypes.byref(n), _build.stream_ptr())
    _build.check(code, "dequant_matmul")
    return n.value


def launch_tc(x: torch.Tensor, planes: torch.Tensor, scale: torch.Tensor,
              out: torch.Tensor, sfmt: StorageFormat, n_width: int,
              split: bool) -> int:
    """Launch the tensor-core route on checked, contiguous CUDA tensors,
    uncounted; the split x and the chunk sums live in workspaces from
    ``torch.empty``.  Returns the kernels launched: the x split, the
    main kernel and, when ``split`` and K spans several chunks, the
    chunk sum."""
    (M, K), N = x.shape, out.shape[1]
    Mp, Kt = -(-M // n_width) * n_width, -(-K // 32)
    chunks = -(-K // KCHUNK)
    xs = torch.empty(2 * Kt * Mp * 32, dtype=torch.float32, device=x.device)
    part = torch.empty(chunks * M * N if split and chunks > 1 else 1,
                       dtype=torch.float32, device=x.device)
    n = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        code = _entry("tc_launch")(
            _build.ptr(x), _build.ptr(planes), _build.ptr(scale),
            _build.ptr(out), _build.ptr(xs), _build.ptr(part), M, K, N,
            sfmt.nbits, sfmt.w_e, sfmt.w_f, n_width, int(split),
            ctypes.byref(n), _build.stream_ptr())
    _build.check(code, "dequant_matmul")
    return n.value


def dequant_matmul_cuda(x: torch.Tensor, planes: torch.Tensor,
                        scale: torch.Tensor, sfmt: StorageFormat, *,
                        N: int) -> torch.Tensor:
    """``x [M, K] @ (decode(planes) * scale)`` -> ``[M, N]`` float32.

    On CUDA tensors this launches ``csrc/dequant_matmul.cu`` on the
    route :func:`plan` picks; on CPU tensors it runs the plain version.
    Any M and K and any N that is a multiple of 32 run; on either route
    the output depends on M only through the rows it holds.
    """
    M, K = x.shape
    nbits, K2, Nw = planes.shape
    if K2 != K or Nw * LANE != N or nbits != sfmt.nbits:
        raise ValueError(f"planes {tuple(planes.shape)} do not fit x "
                         f"{tuple(x.shape)} and N={N} in {sfmt}")
    if x.device.type == "cpu" and planes.device.type == "cpu":
        return dequant_matmul_ref(x, planes, scale, sfmt, N)
    _build.require_cuda(planes)
    scale = torch.as_tensor(scale)
    if x.device != planes.device or scale.device != planes.device \
            or scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError(f"x, planes and a one-element float32 scale must "
                         f"lie on one CUDA device: {x.device}, "
                         f"{planes.device}, {scale.device} {scale.dtype}")
    x = x.to(torch.float32).contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or K == 0:
        return out.zero_()
    p = plan(M, K, sfmt)
    if p["route"] == "fma":
        n = launch(x, planes, scale.contiguous(), out, sfmt)
    else:
        n = launch_tc(x, planes, scale.contiguous(), out, sfmt,
                      p["n_width"], p["split"])
    dequant_matmul_cuda.launches += 1
    dequant_matmul_cuda.kernel_launches += n
    return out


# Calls that launched, and the CUDA kernels they launched (up to three a
# call on the tensor-core route).
dequant_matmul_cuda.launches = 0
dequant_matmul_cuda.kernel_launches = 0
