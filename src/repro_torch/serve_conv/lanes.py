"""Lane packing: coalesce queued images into one wave batch.

The HOBFLOPS activation carrier stores a wave as ``[nbits, P, Mw]``
planes with ``P = B*H*W`` pixel rows and channels along int32 lanes
(DESIGN.md §8) — so the *batch axis is the bitslice row axis*, and the
marginal cost of an extra image in a wave is just more rows through the
same plane-wide netlists.  Serving one image at a time leaves that
width idle; the packer here coalesces N queued requests (possibly
heterogeneous image counts, same HxWxC per engine instance) into one
stacked NHWC batch, padded up to the wave's batch bucket with
all-zero images, with per-request slot bookkeeping so each result is
sliced back out bit-exactly.

Bit-exactness of the whole scheme rests on the fact that every plane
op is elementwise per pixel row (MAC netlists, casts, ReLU) or combines
rows only *within* one image of the batch (``window_gather_planes``
and the im2col both restore the NHWC structure before gathering, so
windows never straddle the batch axis).  A request's rows therefore
compute the same codes whether it rides alone or packed in a wave —
the serve tests assert this bit-for-bit, pad images included.

``stack_requests``/``split_wave`` also exist at the plane level
(``core.bitslice.stack_activations``/``split_activation``) for callers
that hold pre-encoded :class:`BitsliceActivation` carriers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve_conv.errors import (RequestValidationError,
                                          ServeError, host_array)


@dataclasses.dataclass(frozen=True)
class WaveSlot:
    """Where one request's images live inside a packed wave."""
    start: int            # first image index in the wave batch
    count: int            # images this request contributed
    squeeze: bool         # request was a single [H,W,C] image (no batch
                          # dim); unpack restores the original rank


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """A packed wave: the stacked batch geometry plus per-request
    slots.  ``bucket - filled`` trailing images are all-zero pad."""
    slots: tuple[WaveSlot, ...]
    bucket: int

    @property
    def filled(self) -> int:
        return sum(s.count for s in self.slots)

    @property
    def occupancy(self) -> float:
        """Fraction of the wave's batch slots carrying real images —
        the lane-occupancy counter the engine aggregates."""
        return self.filled / self.bucket


def request_images(image) -> int:
    """Image count a request contributes: 1 for [H,W,C], B for
    [B,H,W,C]."""
    nd = np.ndim(image)
    if nd == 3:
        return 1
    if nd == 4:
        return int(np.shape(image)[0])
    raise RequestValidationError(
        f"request image must be [H,W,C] or [B,H,W,C], got rank {nd}")


def pack_wave(images, bucket: int, hwc=None):
    """Stack per-request images into one ``[bucket, H, W, C]`` f32
    batch.

    ``images`` is a sequence of [H,W,C] or [B,H,W,C] float arrays, all
    sharing (H, W, C) (validated against ``hwc`` when given).  Requests
    are laid out contiguously in submission order; slack up to
    ``bucket`` is zero images (the +0 code in every plane — dead rows
    the slots never read back).  Returns ``(batch, WavePlan)``.
    """
    if not images:
        raise ServeError("pack_wave: empty wave")
    slots, parts, off = [], [], 0
    for img in images:
        request_images(img)        # the single rank-contract check
        arr = host_array(img).astype(np.float32, copy=False)
        squeeze = arr.ndim == 3
        if squeeze:
            arr = arr[None]
        if hwc is None:
            hwc = arr.shape[1:]
        elif arr.shape[1:] != tuple(hwc):
            raise RequestValidationError(
                f"request geometry {arr.shape[1:]} != engine geometry "
                f"{tuple(hwc)} (one engine instance serves one HxWxC)")
        slots.append(WaveSlot(off, arr.shape[0], squeeze))
        parts.append(arr)
        off += arr.shape[0]
    if off > bucket:
        raise ServeError(
            f"wave holds {off} images but the bucket is {bucket}")
    if off < bucket:
        parts.append(np.zeros((bucket - off,) + tuple(hwc), np.float32))
    return np.concatenate(parts, axis=0), WavePlan(tuple(slots), bucket)


def unpack_wave(out, plan: WavePlan):
    """Slice a wave output ``[bucket, Ho, Wo, M]`` back into
    per-request results (restoring [Ho,Wo,M] rank for single-image
    requests).  Pure slicing — bit-exact by construction."""
    results = []
    for s in plan.slots:
        r = out[s.start:s.start + s.count]
        results.append(r[0] if s.squeeze else r)
    return results
