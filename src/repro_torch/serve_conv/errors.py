"""Typed error taxonomy for the lane-batched serving engine.

The original engine failed deep: a bad request died as an assert inside
``pack_wave`` (poisoning the whole wave), a failed jit compile unwound
through ``run_wave`` with the queue half-popped, and queue growth was
unbounded.  Serving robustness starts with *names* for the ways serving
fails, raised at the earliest boundary that can detect them:

``ServeError``
    Base of everything the engine raises on purpose.  Anything else
    escaping a wave is a defect (or injected chaos) and is converted to
    :class:`WaveExecutionError` by the executor's retry loop.

``RequestValidationError``
    The request itself is unservable — wrong rank/geometry, non-float
    dtype, NaN/Inf payload.  Raised by ``submit()`` *before* the
    request enters the queue, so a bad request can never poison a wave.
    Subclasses ``ValueError`` so pre-taxonomy callers that caught
    ``ValueError`` keep working.

``QueueFullError``
    Bounded-queue admission control: the queue already holds
    ``max_queue_images`` images.  Shedding at submit keeps latency
    bounded instead of letting the backlog (and every queued request's
    deadline miss) grow without limit.

``DeadlineExceededError``
    A queued request aged past its deadline before a wave could take
    it.  Recorded on the request (``req.error``), not raised — the
    submitter already got their synchronous ``submit()`` back.

``WaveExecutionError``
    A wave failed after the executor exhausted its retry budget.  Also
    recorded on each quarantined request rather than raised, so one
    poisoned wave cannot take the engine down: the engine keeps
    admitting and serving subsequent waves.

``WaveShardingError``
    A wave batch that cannot split over the configured device mesh —
    an engine-configuration bug, surfaced with the mesh arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch


class ServeError(Exception):
    """Base class for every intentional serving-path failure."""


class RequestValidationError(ServeError, ValueError):
    """The request payload is unservable (shape/dtype/NaN/Inf)."""


class QueueFullError(ServeError):
    """Bounded queue is full; the request was shed at submit()."""


class DeadlineExceededError(ServeError):
    """The request aged out of its deadline while queued."""


class WaveExecutionError(ServeError):
    """A wave failed after the retry budget; its requests are
    quarantined.  ``attempts`` counts executions tried; ``__cause__``
    holds the last underlying error."""

    def __init__(self, msg: str, attempts: int = 1):
        super().__init__(msg)
        self.attempts = attempts


class WaveShardingError(ServeError, ValueError):
    """A wave batch that does not divide over the device mesh."""


def host_array(image) -> np.ndarray:
    """A request payload as a numpy array on the host: tensors (on any
    device) are copied back, bfloat16 widened to float32 (numpy has no
    bfloat16); anything else goes through ``np.asarray``."""
    if isinstance(image, torch.Tensor):
        t = image.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(image)


def validate_request_image(image, hwc=None, *,
                           max_images: int | None = None) -> int:
    """Admission-time payload validation; returns the image count.
    ``image`` is a numpy array or a tensor on any device.

    Checks — each a :class:`RequestValidationError` naming the defect —
    in order: rank is 3 ([H,W,C]) or 4 ([B,H,W,C]); dtype is a real
    float (codes for int payloads would be garbage, not a quantization);
    geometry matches the engine's ``hwc``; image count fits
    ``max_images``; every element is finite (NaN/Inf would encode to
    exception codes and quietly propagate through every downstream
    netlist of the wave).
    """
    arr = host_array(image)
    if arr.ndim not in (3, 4):
        raise RequestValidationError(
            f"request image must be [H,W,C] or [B,H,W,C], got rank "
            f"{arr.ndim} (shape {arr.shape})")
    if not np.issubdtype(arr.dtype, np.floating):
        raise RequestValidationError(
            f"request image dtype {arr.dtype} is not a float type")
    if hwc is not None and arr.shape[-3:] != tuple(hwc):
        raise RequestValidationError(
            f"request geometry {arr.shape[-3:]} != engine geometry "
            f"{tuple(hwc)} (one engine instance serves one HxWxC)")
    n = 1 if arr.ndim == 3 else int(arr.shape[0])
    if max_images is not None and n > max_images:
        raise RequestValidationError(
            f"request carries {n} images > max_batch {max_images}; "
            f"split it across requests")
    if not np.isfinite(arr).all():
        bad = int(arr.size - np.isfinite(arr).sum())
        raise RequestValidationError(
            f"request payload holds {bad} non-finite element(s) "
            f"(NaN/Inf); rejected before it can poison a wave")
    return n
