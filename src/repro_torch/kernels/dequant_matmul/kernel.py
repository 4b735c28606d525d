"""The fused bitplane-dequant matmul as a CUDA kernel, with its wrapper.

Port of ``repro.kernels.dequant_matmul.kernel.dequant_matmul_pallas``:
weights stay in device memory as HOBFLOPS StorageFormat codes in
``nbits`` bit planes (exactly ``nbits`` bits a weight), and each
``[BK, BN]`` weight tile is rebuilt and decoded in shared memory right
before the f32 FMAs consume it (``csrc/dequant_matmul.cu``; its header
note says what bounds it on the H100).  No tensor cores: TF32 would
break the reference's 1e-5 tolerance.

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
# Tile configurations of the source, by index: a 64x64 output tile, and
# an 8x32 tile that gives a decode step's few rows more blocks along N.
TILE_M64, TILE_M8 = 0, 1
# Up to SMALL_M rows take the 8x32 tile.  A layer of qwen2-0.5b's
# projections (2 wq/wo + 2 wk/wv + 2 w_gate/w_up + w_down) takes 0.47 of
# the 64x64 tile's time with it at M <= 4, 0.71 at M = 64 and 1.09 at
# M = 128 (scripts/torch_dequant_tiles.py on an H100 80GB HBM3, 700 W).
SMALL_M = 64


def tile_for(M: int) -> int:
    """The tile configuration a launch over ``M`` rows uses."""
    return TILE_M8 if M <= SMALL_M else TILE_M64


def build_job() -> tuple[str, str]:
    """The ``(name, source)`` pair :func:`_build.build` compiles."""
    return "dequant_matmul", (_build.CSRC / "dequant_matmul.cu").read_text()


_BOUND: dict = {}


def load(library: _build.Library) -> None:
    """Bind the C entry of a built ``dequant_matmul`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _BOUND["launch"] = _build.bind(
        library.lib, "dequant_matmul_launch",
        [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp])


def _launch_fn():
    if "launch" not in _BOUND:
        load(_build.build([build_job()])[0])
    return _BOUND["launch"]


def launch(x: torch.Tensor, planes: torch.Tensor, scale: torch.Tensor,
           out: torch.Tensor, sfmt: StorageFormat, tile: int) -> None:
    """Launch tile configuration ``tile`` on checked, contiguous CUDA
    tensors, uncounted.  ``scripts/torch_dequant_tiles.py`` times both
    configurations with it; everything else goes through
    :func:`dequant_matmul_cuda`."""
    (M, K), N = x.shape, out.shape[1]
    with torch.cuda.device(x.device):
        code = _launch_fn()(_build.ptr(x), _build.ptr(planes),
                            _build.ptr(scale), _build.ptr(out), M, K, N,
                            sfmt.nbits, sfmt.w_e, sfmt.w_f, tile,
                            _build.stream_ptr())
    _build.check(code, "dequant_matmul")


def dequant_matmul_cuda(x: torch.Tensor, planes: torch.Tensor,
                        scale: torch.Tensor, sfmt: StorageFormat, *,
                        N: int) -> torch.Tensor:
    """``x [M, K] @ (decode(planes) * scale)`` -> ``[M, N]`` float32.

    On CUDA tensors this launches ``csrc/dequant_matmul.cu`` with the
    tile :func:`tile_for` picks for M; on CPU tensors it runs the plain
    version.  Any M and K and any N that is a multiple of 32 run; the
    output never depends on the tile.
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
    if M == 0:
        return out
    launch(x, planes, scale.contiguous(), out, sfmt, tile_for(M))
    dequant_matmul_cuda.launches += 1
    return out


dequant_matmul_cuda.launches = 0
