"""Bitslice (bit-plane) transforms: code words <-> bit planes.

The bitslice layout (paper Fig. 3a) stores N custom-FP code words as
``nbits`` planes; plane ``b``, lane-word ``w`` holds bit ``b`` of codes
``w*L .. w*L+L-1`` packed into one machine word of L lanes.  The torch
data path uses int32 lane words: a CUDA thread works on one 32-bit
register, so each gate instruction advances 32 independent lanes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .fpformat import FPFormat


# ---------------------------------------------------------------------------
# numpy host-side transforms (uint64 lane words; testing + data prep)
# ---------------------------------------------------------------------------
def pack_planes_np(codes: np.ndarray, nbits: int,
                   lane_bits: int = 64) -> np.ndarray:
    """[N] int codes -> [nbits, ceil(N/lane_bits)] uint64 bit planes."""
    codes = np.asarray(codes, dtype=np.uint64).ravel()
    n = codes.shape[0]
    nwords = -(-n // lane_bits)
    padded = np.zeros(nwords * lane_bits, dtype=np.uint64)
    padded[:n] = codes
    padded = padded.reshape(nwords, lane_bits)
    weights = (np.uint64(1) << np.arange(lane_bits, dtype=np.uint64))
    planes = np.empty((nbits, nwords), dtype=np.uint64)
    for b in range(nbits):
        bits = (padded >> np.uint64(b)) & np.uint64(1)
        planes[b] = (bits * weights).sum(axis=1, dtype=np.uint64)
    return planes


def unpack_planes_np(planes: np.ndarray, n: int,
                     lane_bits: int = 64) -> np.ndarray:
    """[nbits, W] planes -> [n] int64 codes."""
    nbits, nwords = planes.shape
    codes = np.zeros(nwords * lane_bits, dtype=np.int64)
    for b in range(nbits):
        bits = (planes[b][:, None].astype(np.uint64)
                >> np.arange(lane_bits, dtype=np.uint64)) & np.uint64(1)
        codes |= bits.astype(np.int64).ravel() << b
    return codes[:n]


# ---------------------------------------------------------------------------
# torch transforms (int32 lane words; the device data path)
# ---------------------------------------------------------------------------
def pack_planes(codes: torch.Tensor, nbits: int,
                lane_bits: int = 32) -> torch.Tensor:
    """[..., N] int32 codes -> [nbits, ..., ceil(N / lane_bits)] int32
    planes.

    N is zero-padded to a multiple of lane_bits internally (mirroring
    ``pack_planes_np``; the all-zero code is +0, the MAC identity).
    Each lane word is the sum of distinct powers of two, the top one
    being the int32 ``1 << 31``; torch sums int32 in int64, and the sum
    always lies in the int32 range, so narrowing it back is exact.
    """
    codes = codes.to(torch.int32)
    n = codes.shape[-1]
    pad = (-n) % lane_bits
    if pad:
        codes = F.pad(codes, (0, pad))
        n += pad
    grouped = codes.reshape(*codes.shape[:-1], n // lane_bits, lane_bits)
    weights = torch.ones((), dtype=torch.int32, device=codes.device) \
        << torch.arange(lane_bits, dtype=torch.int32, device=codes.device)
    planes = []
    for b in range(nbits):
        bits = (grouped >> b) & 1
        planes.append((bits * weights).sum(dim=-1).to(torch.int32))
    return torch.stack(planes, dim=0)


def unpack_planes(planes: torch.Tensor, lane_bits: int = 32) -> torch.Tensor:
    """[nbits, ..., W] int32 planes -> [..., W * lane_bits] int32 codes.
    Arithmetic shifts followed by ``& 1`` read each lane's bit (torch
    has no unsigned 32-bit shifts on the CPU)."""
    nbits = planes.shape[0]
    shifts = torch.arange(lane_bits, dtype=torch.int32, device=planes.device)
    codes = None
    for b in range(nbits):
        term = ((planes[b][..., None] >> shifts) & 1) << b
        codes = term if codes is None else codes | term
    return codes.reshape(*codes.shape[:-2], -1)


def window_gather_planes(planes: torch.Tensor, shape, kh: int, kw: int,
                         stride: int = 1, pad_h: int = 0, pad_w: int = 0,
                         fill_code: int = 0):
    """Pool-window plane gather: stack kh x kw shifted views of a plane
    array without leaving the bitslice domain.

    ``planes`` is ``[nbits, P, Mw]`` (the activation carrier layout:
    pixels along rows, channels along int32 lanes) and ``shape`` the
    logical NHWC shape.  Because a pooling window combines *pixels* of
    the *same* channel, and channels live in lanes, the gather is pure
    row selection — every lane stays aligned.  Returns
    ``([kh*kw, nbits, B*Ho*Wo, Mw] windows, (Ho, Wo))``; window
    position (i, j) is entry ``i*kw + j``.

    ``pad_h``/``pad_w`` add spatial padding (split low-half-first like
    the im2col SAME convention) whose slots hold ``fill_code`` across
    all lanes — +0 (the add identity) for average pools, -inf (the max
    identity) for max pools.
    """
    nb, P, Mw = planes.shape
    B, H, W, C = shape
    assert P >= B * H * W, (P, shape)
    x = planes[:, :B * H * W, :].reshape(nb, B, H, W, Mw)
    if pad_h or pad_w:
        ph0, pw0 = pad_h // 2, pad_w // 2
        x = F.pad(x, (0, 0, pw0, pad_w - pw0, ph0, pad_h - ph0))
        if fill_code:
            # Per-plane fill word: all 32 lanes carry bit b of the code.
            fill = torch.tensor([-((fill_code >> b) & 1) for b in range(nb)],
                                dtype=torch.int32, device=planes.device)
            interior = F.pad(torch.ones((H, W), dtype=torch.int32,
                                        device=planes.device),
                             (pw0, pad_w - pw0, ph0, pad_h - ph0))
            x = torch.where(interior[None, None, :, :, None] == 0,
                            fill[:, None, None, None, None], x)
    Ho = (x.shape[2] - kh) // stride + 1
    Wo = (x.shape[3] - kw) // stride + 1
    wins = []
    for i in range(kh):
        for j in range(kw):
            wins.append(x[:, :, i:i + (Ho - 1) * stride + 1:stride,
                          j:j + (Wo - 1) * stride + 1:stride, :])
    wins = torch.stack(wins, dim=0)
    return wins.reshape(kh * kw, nb, B * Ho * Wo, Mw), (Ho, Wo)


# ---------------------------------------------------------------------------
# Bitslice-resident activation carrier (the inter-layer HOBFLOPS tensor)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class BitsliceActivation:
    """A feature map held in the HOBFLOPS bitslice domain.

    This is the tensor that flows *between* layers of the
    bitslice-resident pipeline (paper §3.4: "data stays in HOBFLOPS
    format between layers"): the OFM bit planes exactly as the MAC
    kernel emits them, so chaining layers is zero-copy.

    Layout (the kernel's native OFM layout):

    * ``planes`` — ``[fmt.nbits, P, Mw]`` int32: plane ``b``, row ``p``,
      lane word ``w`` holds bit ``b`` of the codes for pixel ``p``,
      channels ``32*w .. 32*w+31`` (channels packed along int32 lanes).
    * ``shape``  — the logical NHWC shape ``(B, H, W, C)``.  ``P`` is at
      least ``B*H*W`` and ``Mw*32 >= C`` (padded rows/lanes hold the
      all-zero +0 code, the MAC identity).
    * ``fmt``    — the FPFormat of the stored codes (a layer output
      carries the accumulator format ``fmt.mult_out(extended)`` until
      cast back down at the next layer's boundary).
    """
    planes: torch.Tensor
    fmt: FPFormat
    shape: tuple[int, int, int, int]

    def __post_init__(self):
        assert len(self.shape) == 4, self.shape
        assert self.planes.ndim == 3, self.planes.shape
        assert self.planes.shape[0] == self.fmt.nbits, \
            (self.planes.shape, self.fmt)

    @property
    def nbits(self) -> int:
        return self.fmt.nbits

    @property
    def n_pixels(self) -> int:
        B, H, W, _ = self.shape
        return B * H * W


def stack_activations(acts):
    """Coalesce per-request activations into one wave-batched carrier.

    All activations must share the spatial/channel geometry ``(H, W, C)``
    and the format; batch counts may differ (heterogeneous requests).
    Because the carrier's row axis is ``B*H*W`` — the batch lives in
    *rows*, channels in int32 lanes — stacking is pure row
    concatenation: each input is trimmed to its logical ``n_pixels``
    rows and the slabs are joined in order.  The result decodes to the
    row-wise concatenation of the inputs, bit-exactly.
    """
    assert acts, "stack_activations: need at least one activation"
    fmt = acts[0].fmt
    _, H, W, C = acts[0].shape
    for a in acts:
        assert a.fmt == fmt, (a.fmt, fmt)
        assert a.shape[1:] == (H, W, C), (a.shape, (H, W, C))
    planes = torch.cat([a.planes[:, :a.n_pixels, :] for a in acts], dim=1)
    B = sum(a.shape[0] for a in acts)
    return BitsliceActivation(planes, fmt, (B, H, W, C))


def split_activation(act: BitsliceActivation, batch_sizes):
    """Slice a wave-batched activation back into per-request carriers.

    ``batch_sizes`` are per-request image counts summing to at most the
    wave batch (trailing slack is pad).  The inverse of
    :func:`stack_activations` up to row padding: slicing rows
    ``[off : off + b*H*W]`` recovers exactly the codes each request
    contributed, so round-tripping is bit-exact.
    """
    _, H, W, C = act.shape
    rows = H * W
    assert sum(batch_sizes) <= act.shape[0], (batch_sizes, act.shape)
    out, off = [], 0
    for b in batch_sizes:
        out.append(BitsliceActivation(
            act.planes[:, off:off + b * rows, :], act.fmt, (b, H, W, C)))
        off += b * rows
    return out
