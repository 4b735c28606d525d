"""The paper's CNN convolution on the bitslice-parallel HOBFLOPS MAC.

Convolution is lowered to the verified bitslice GEMM by im2col: IFM
patches [B*Ho*Wo, kh*kw*C] against kernels [kh*kw*C, M] (the paper's
Fig. 5 layout with LANES of kernels per bitslice word).  ReLU runs *in
the HOBFLOPS domain* as one bitwise op per plane: clearing every plane
where the sign plane is set maps negative values to the canonical +0
code (exc=00) — activation for free inside the bitslice pipeline.

The layer is split into explicit stages so multi-layer networks stay in
the bitslice domain between layers — the "data stays in HOBFLOPS format
between layers" flow of paper §3.4, realized end-to-end by
``conv2d_bitslice.network.NetworkGraph``:

* :func:`encode_activations`   — f32 NHWC -> :class:`BitsliceActivation`
* :func:`conv_core`            — activation x ConvWeights -> activation
                                 (plane-domain im2col + bitslice MAC
                                 kernel + in-domain ReLU)
* :func:`cast_activations`     — accumulator-format planes -> next
                                 layer's operand format, via the
                                 optimized ``build_cast`` netlist
* :func:`decode_activations`   — activation -> f32 NHWC

Only the MAC runs in a hand-written kernel; the cast, add, max and scale
netlists, the pooling folds and the im2col are plain torch bitwise ops
(``make_torch_fn``), on the card too.  ``hobflops_conv2d`` composes
encode/conv_core/decode for the one-layer case.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _build
from repro_torch._build import resolve_device
from repro_torch.core import softfloat as sf
from repro_torch.core.bitslice import (BitsliceActivation, pack_planes,
                                       unpack_planes, window_gather_planes)
from repro_torch.core.fpformat import EXC_INF, RNE, FPFormat
from repro_torch.core.fused_backend import fused_variant
from repro_torch.kernels.bitslice_mac.kernel import (add_netlist_fn,
                                                     cast_netlist_fn,
                                                     max_netlist_fn,
                                                     scale_netlist_fn)
from repro_torch.kernels.bitslice_mac.ops import (LANE, _pad_to,
                                                  encode_weight_planes,
                                                  mac_planes)


def _conv_pad(H: int, W: int, kh: int, kw: int, stride: int,
              padding: str) -> tuple[int, int]:
    """Total (pad_h, pad_w) applied by :func:`im2col`."""
    if padding == "SAME":
        return (max((-(-H // stride) - 1) * stride + kh - H, 0),
                max((-(-W // stride) - 1) * stride + kw - W, 0))
    return 0, 0


def conv_out_hw(H: int, W: int, kh: int, kw: int, stride: int = 1,
                padding: str = "SAME") -> tuple[int, int]:
    """Output spatial dims of :func:`im2col` (exact, incl. clamped
    SAME padding) — used for the network runner's shape plan."""
    pad_h, pad_w = _conv_pad(H, W, kh, kw, stride, padding)
    return ((H + pad_h - kh) // stride + 1,
            (W + pad_w - kw) // stride + 1)


def im2col(images: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """[B, H, W, C] -> patches [B, Ho, Wo, kh*kw*C] (SAME pads split
    low-half-first, as XLA does)."""
    B, H, W, C = images.shape
    pad_h, pad_w = _conv_pad(H, W, kh, kw, stride, padding)
    x = F.pad(images, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                       pad_h // 2, pad_h - pad_h // 2))
    Ho = (x.shape[1] - kh) // stride + 1
    Wo = (x.shape[2] - kw) // stride + 1
    cols = [x[:, i:i + (Ho - 1) * stride + 1:stride,
              j:j + (Wo - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1).reshape(B, Ho, Wo, kh * kw * C)


def hobflops_relu_planes(planes: torch.Tensor, fmt: FPFormat):
    """OFM bit planes [NOUT, ...] -> ReLU'd planes.  One ANDN per plane.

    Every code whose *sign bit* is set — negative normals, -0, -inf, and
    any non-canonical sign-set NaN — becomes the canonical all-zero +0
    code (exc=00); every sign-clear code passes through unchanged (the
    ``softfloat.fp_relu`` semantics)."""
    return planes & ~planes[fmt.sign_off][None]


# ---------------------------------------------------------------------------
# Pre-encoded conv weights (encode static kernels once, reuse per call)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class ConvWeights:
    """Conv kernels pre-encoded to HOBFLOPS bit planes.

    ``planes`` is ``[kh*kw*cin, NIN, Mw]`` int32 (reduction axis in
    im2col (i, j, c) order, output channels packed along int32 lanes,
    padded to the next lane word).
    """
    planes: torch.Tensor
    kh: int
    kw: int
    cin: int
    cout: int
    fmt: FPFormat

    def to(self, device) -> "ConvWeights":
        return dataclasses.replace(self, planes=self.planes.to(device))


def encode_conv_weights(kernels, fmt: FPFormat, rounding: str = RNE,
                        device="cuda") -> ConvWeights:
    """f32 [kh,kw,C,M] (numpy or torch) -> :class:`ConvWeights` on
    ``device`` (encode + bitslice once)."""
    device = resolve_device(device)
    k = torch.as_tensor(np.asarray(kernels, np.float32)
                        if not isinstance(kernels, torch.Tensor)
                        else kernels, dtype=torch.float32, device=device)
    kh, kw, C, M = k.shape
    planes = encode_weight_planes(k.reshape(kh * kw * C, M), fmt, rounding)
    return ConvWeights(planes, kh, kw, C, M, fmt)


# ---------------------------------------------------------------------------
# Pipeline stages: encode / im2col-in-planes / conv_core / cast / decode
# ---------------------------------------------------------------------------
def encode_activations(images: torch.Tensor, fmt: FPFormat,
                       rounding: str = RNE) -> BitsliceActivation:
    """f32 [B,H,W,C] -> bitslice activation (the pipeline's single
    entry encode)."""
    B, H, W, C = images.shape
    codes = sf.encode_torch(images.reshape(B * H * W, C), fmt, rounding)
    planes = pack_planes(codes, fmt.nbits)     # pads C to a lane word
    return BitsliceActivation(planes, fmt, (B, H, W, C))


def decode_activations(act: BitsliceActivation) -> torch.Tensor:
    """Bitslice activation -> f32 [B,H,W,C] (the single exit decode)."""
    B, H, W, C = act.shape
    codes = unpack_planes(act.planes)          # [P, Mw*LANE]
    vals = sf.decode_torch(codes, act.fmt)
    return vals[:B * H * W, :C].reshape(B, H, W, C)


def _netlist_out(fn, nbits: int, lanes_like: torch.Tensor, **planes):
    return fn(**planes)["out"].expand((nbits,) + lanes_like.shape[1:])


def cast_activations(act: BitsliceActivation, dst_fmt: FPFormat,
                     rounding: str = RNE) -> BitsliceActivation:
    """Re-round an activation into ``dst_fmt`` without leaving the
    bitslice domain: the optimized ``build_cast`` netlist runs as a few
    dozen bitwise ops over the plane array.  Bit-exact to
    decode -> f32 -> encode (``softfloat.fp_cast``)."""
    if act.fmt == dst_fmt:
        return act
    fn, _ = cast_netlist_fn(act.fmt, dst_fmt, rounding)
    out = _netlist_out(fn, dst_fmt.nbits, act.planes, x=act.planes)
    return BitsliceActivation(out, dst_fmt, act.shape)


def activation_patch_masks(act: BitsliceActivation, kh: int, kw: int,
                           stride: int = 1, padding: str = "SAME"):
    """Plane-domain im2col: gather layer-(n+1) IFM patches directly
    from layer-n output planes.

    Expands the channel-lane-packed planes to per-(pixel, channel) 0/-1
    broadcast masks (pure shift/mask ops — no f32 materialization),
    restores the NHWC spatial structure, and gathers kh x kw patches in
    the mask domain.  SAME padding inserts all-zero masks == the +0
    code, the MAC identity.  Returns ``(i_masks [B*Ho*Wo, kh*kw*C, NIN],
    (Ho, Wo))``.
    """
    nb = act.nbits
    B, H, W, C = act.shape
    shifts = torch.arange(LANE, dtype=torch.int32, device=act.planes.device)
    bits = (act.planes[:, :, :, None] >> shifts) & 1   # [nb, P, Mw, LANE]
    masks = -bits.reshape(nb, bits.shape[1], -1)[:, :B * H * W, :C]
    masks = masks.movedim(0, -1).reshape(B, H, W, C * nb)  # [.., C, nb]
    pat = im2col(masks, kh, kw, stride, padding)
    _, Ho, Wo, _ = pat.shape
    return pat.reshape(B * Ho * Wo, kh * kw * C, nb).contiguous(), (Ho, Wo)


# ---------------------------------------------------------------------------
# Plane-domain elementwise / pooling ops (the graph runner's node kinds)
# ---------------------------------------------------------------------------
def relu_activations(act: BitsliceActivation) -> BitsliceActivation:
    """In-domain ReLU as a standalone graph node (one ANDN per plane;
    see :func:`hobflops_relu_planes`)."""
    return BitsliceActivation(hobflops_relu_planes(act.planes, act.fmt),
                              act.fmt, act.shape)


def _align_rows(a: torch.Tensor, b: torch.Tensor):
    """Zero-pad the shorter of two plane arrays along the row axis so
    elementwise netlists can combine activations whose P padding
    differs (zero rows are the +0 code — identity for add, and beyond
    every logical pixel for max)."""
    P = max(a.shape[1], b.shape[1])
    return _pad_to(a, P, 1), _pad_to(b, P, 1)


def add_activations(a: BitsliceActivation, b: BitsliceActivation,
                    fmt: FPFormat | None = None,
                    rounding: str = RNE) -> BitsliceActivation:
    """Elementwise FP add of two activations in the plane domain — the
    residual-merge node.  Branches whose formats differ are first cast
    to ``fmt`` (default: the first operand's format); the sum is
    computed by the optimized ``build_add`` netlist at that format."""
    assert a.shape == b.shape, (a.shape, b.shape)
    tgt = fmt or a.fmt
    a = cast_activations(a, tgt, rounding)
    b = cast_activations(b, tgt, rounding)
    pa, pb = _align_rows(a.planes, b.planes)
    fn, _ = add_netlist_fn(tgt, rounding)
    out = _netlist_out(fn, tgt.nbits, pa, x=pa, y=pb)
    return BitsliceActivation(out, tgt, a.shape)


def _fold_pairwise(items, combine):
    """Balanced pairwise reduction (the 'add-tree' order); both the
    resident plane path and the word-parallel oracle fold windows with
    this exact shape, so they stay bit-identical even though FP add is
    not associative."""
    items = list(items)
    while len(items) > 1:
        nxt = [combine(items[i], items[i + 1])
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def _pool_geometry(act: BitsliceActivation, window, stride, padding):
    kh, kw = (window, window) if isinstance(window, int) else window
    stride = stride or kh
    B, H, W, C = act.shape
    pad_h, pad_w = _conv_pad(H, W, kh, kw, stride, padding)
    return kh, kw, stride, pad_h, pad_w


def neg_inf_code(fmt: FPFormat) -> int:
    """The canonical -inf code word — the max identity, used to fill
    SAME-padding slots of a plane-domain maxpool."""
    return (1 << fmt.sign_off) | (EXC_INF << fmt.exc_off)


def maxpool2d_activations(act: BitsliceActivation, window=2,
                          stride: int | None = None,
                          padding: str = "VALID") -> BitsliceActivation:
    """Max pooling entirely inside the bitslice domain: windows gathered
    by pure row selection and folded pairwise through the optimized
    ``build_max`` netlist (``softfloat.fp_max`` semantics).  SAME
    padding fills with -inf, the max identity; ``stride`` defaults to
    the window size."""
    kh, kw, stride, pad_h, pad_w = _pool_geometry(act, window, stride,
                                                  padding)
    wins, (Ho, Wo) = window_gather_planes(
        act.planes, act.shape, kh, kw, stride, pad_h, pad_w,
        fill_code=neg_inf_code(act.fmt))
    fn, _ = max_netlist_fn(act.fmt)
    nb = act.fmt.nbits
    out = _fold_pairwise(list(wins),
                         lambda x, y: _netlist_out(fn, nb, x, x=x, y=y))
    B, _, _, C = act.shape
    return BitsliceActivation(out, act.fmt, (B, Ho, Wo, C))


def avgpool2d_activations(act: BitsliceActivation, window=2,
                          stride: int | None = None,
                          padding: str = "VALID",
                          rounding: str = RNE) -> BitsliceActivation:
    """Average pooling in the bitslice domain: a pairwise ``build_add``
    tree over the window followed by one ``build_scale`` (multiply by
    ``2**-log2(window area)``) — no divider, so the window area must be
    a power of two.  SAME padding fills with +0 and still divides by the
    full window area (count-include-pad)."""
    kh, kw, stride, pad_h, pad_w = _pool_geometry(act, window, stride,
                                                  padding)
    area = kh * kw
    assert area & (area - 1) == 0, \
        f"avgpool window area must be a power of two, got {kh}x{kw}"
    wins, (Ho, Wo) = window_gather_planes(
        act.planes, act.shape, kh, kw, stride, pad_h, pad_w, fill_code=0)
    fn, _ = add_netlist_fn(act.fmt, rounding)
    nb = act.fmt.nbits
    summed = _fold_pairwise(list(wins),
                            lambda x, y: _netlist_out(fn, nb, x, x=x, y=y))
    sfn, _ = scale_netlist_fn(act.fmt, area.bit_length() - 1)
    out = _netlist_out(sfn, nb, summed, x=summed)
    B, _, _, C = act.shape
    return BitsliceActivation(out, act.fmt, (B, Ho, Wo, C))


def derive_blocks(P: int, K: int, M: int, *, p_block: int | None = None,
                  m_block: int | None = None, c_block: int | None = None,
                  c_unroll: int | None = None,
                  kernel: str = "bitslice_mac") -> dict:
    """Launch parameters for a [P, K] @ [K, M] bitslice GEMM on Hopper:
    :func:`repro_torch._build.launch_blocks` for ``kernel`` over the
    ``ceil(M / 32)`` lane words.  Outputs never depend on these."""
    return _build.launch_blocks(P, K, -(-M // LANE), p_block=p_block,
                                m_block=m_block, c_block=c_block,
                                c_unroll=c_unroll, kernel=kernel)


def conv_core(act: BitsliceActivation, weights: ConvWeights, *,
              stride: int = 1, padding: str = "SAME",
              extended: bool = False, rounding: str = RNE,
              relu: bool = False, backend: str = "cuda_fused",
              p_block: int | None = None, m_block: int | None = None,
              c_block: int | None = None,
              c_unroll: int | None = None) -> BitsliceActivation:
    """One conv layer entirely inside the bitslice domain.

    Consumes an activation in the layer's operand format, performs the
    plane-domain im2col + bitslice MAC (+ in-domain ReLU, fused into the
    kernel on ``cuda_fused``), and returns the OFM activation in the
    accumulator format ``weights.fmt.mult_out(extended)``.
    """
    assert act.fmt == weights.fmt, (act.fmt, weights.fmt)
    assert act.shape[3] == weights.cin, (act.shape, weights.cin)
    i_masks, (Ho, Wo) = activation_patch_masks(
        act, weights.kh, weights.kw, stride, padding)
    B = act.shape[0]
    P, K, M = B * Ho * Wo, weights.kh * weights.kw * weights.cin, \
        weights.cout
    blk = derive_blocks(P, K, M, p_block=p_block, m_block=m_block,
                        c_block=c_block, c_unroll=c_unroll,
                        kernel="fused_mac" if backend == "cuda_fused"
                        else "bitslice_mac")
    out = mac_planes(i_masks, weights.planes, fmt=weights.fmt,
                     backend=backend, extended=extended, rounding=rounding,
                     relu=relu, blocks=blk)
    return BitsliceActivation(out, weights.fmt.mult_out(extended),
                              (B, Ho, Wo, M))


def hobflops_conv2d(images, kernels, *, fmt: FPFormat, stride: int = 1,
                    padding: str = "SAME", extended: bool = False,
                    rounding: str = RNE, relu: bool = False,
                    backend: str = "cuda_fused", device="cuda",
                    p_block: int | None = None, m_block: int | None = None,
                    c_block: int | None = None,
                    c_unroll: int | None = None) -> torch.Tensor:
    """images [B,H,W,C] f32, kernels [kh,kw,C,M] f32 (or a pre-encoded
    :class:`ConvWeights`) -> [B,Ho,Wo,M] f32 on ``device``, computed
    entirely in HOBFLOPS bitslice arithmetic.

    This is the one-layer composition encode -> conv_core -> decode.
    Multi-layer networks should use
    :class:`repro_torch.kernels.conv2d_bitslice.network.NetworkGraph`,
    which keeps the interior boundaries in the bitslice domain."""
    device = resolve_device(device)
    if isinstance(kernels, ConvWeights):
        kernels = kernels.to(device)
    else:
        kernels = encode_conv_weights(kernels, fmt, rounding, device)
    assert kernels.fmt == fmt, (kernels.fmt, fmt)
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    act = encode_activations(images, fmt, rounding)
    out = conv_core(act, kernels, stride=stride, padding=padding,
                    extended=extended, rounding=rounding, relu=relu,
                    backend=backend, p_block=p_block, m_block=m_block,
                    c_block=c_block, c_unroll=c_unroll)
    return decode_activations(out)


# Errors that mean "this block-size candidate cannot launch" (shape /
# block checks before a launch, a kernel launch that returned an error).
# Deliberately NOT BaseException: KeyboardInterrupt and SystemExit
# propagate out of the sweep immediately.
_LAUNCH_ERRORS = (ValueError, TypeError, AssertionError,
                  NotImplementedError, IndexError, RuntimeError)


def default_tune_candidates(backend: str = "cuda_fused") -> list[dict]:
    """Backend-aware candidate set for :func:`tune_conv_blocks`.

    The CUDA backends sweep the shape of a block's chains (``m_block``
    lane words of 8, 16 or 32, ``p_block`` rows derived to fill the
    kernel's default chains a block), the ring slot's channels
    (``c_block``: the kernel's default and twice it) and the chain depth
    (``c_unroll`` 2 or 4; each depth is one more ``nvcc`` build of the
    fused kernel).  The plain ``torch`` backend has no blocks and sweeps
    the chain depth only.
    """
    if backend == "torch":
        return [{"c_unroll": u} for u in (1, 2, 4)]
    slots = {"cuda_fused": (_build.FUSED_C_BLOCK, 2 * _build.FUSED_C_BLOCK),
             "cuda": (_build.C_BLOCK, 2 * _build.C_BLOCK)}[backend]
    return [{"m_block": m, "c_block": cb, "c_unroll": u}
            for m in (8, 16, 32) for cb in slots for u in (2, 4)]


def tune_conv_blocks(images, kernels, *, fmt: FPFormat,
                     backend: str = "cuda_fused", device="cuda",
                     candidates=None, iters: int = 2, rounding: str = RNE,
                     **conv_kw):
    """Small sweep helper: time ``hobflops_conv2d`` over launch-block
    candidates on ``device`` and return ``(best_blocks, results)``.

    ``candidates`` is an iterable of dicts with any of
    ``p_block/m_block/c_block/c_unroll`` set (missing keys fall back to
    the derived defaults); by default :func:`default_tune_candidates`.
    ``results`` maps the *resolved* parameter tuple
    (:func:`derive_blocks` for the backend's kernel, the fused kernel's
    chain depth as :func:`fused_variant` clamps it) to seconds/call —
    candidates that resolve to the same launch are timed once.  Weights
    are encoded once, outside the timings; each timing synchronises the
    device.  Only launch-relevant errors (``_LAUNCH_ERRORS``) mark a
    candidate as failed — interrupts re-raise immediately — and if
    every candidate fails the final ``RuntimeError`` names the last
    failing candidate dict and its error.
    """
    device = resolve_device(device)
    if candidates is None:
        candidates = default_tune_candidates(backend)
    if not isinstance(kernels, ConvWeights):
        kernels = encode_conv_weights(kernels, fmt, rounding, device)
    kernels = kernels.to(device)
    images = torch.as_tensor(np.asarray(images, np.float32)
                             if not isinstance(images, torch.Tensor)
                             else images, dtype=torch.float32, device=device)
    khh, kww, C, M = kernels.kh, kernels.kw, kernels.cin, kernels.cout
    B, H, W, _ = images.shape
    # Resolve through the same clamping the launch will apply so
    # equivalent candidates dedupe — with the exact strided Ho*Wo patch
    # count, not the unstrided B*H*W (which could clamp differently).
    Ho, Wo = conv_out_hw(H, W, khh, kww, conv_kw.get("stride", 1),
                         conv_kw.get("padding", "SAME"))
    kernel = "fused_mac" if backend == "cuda_fused" else "bitslice_mac"
    results: dict[tuple, float] = {}
    best, best_dt = None, float("inf")
    last_err, last_cand = None, None
    for cand in candidates:
        blk = derive_blocks(B * Ho * Wo, khh * kww * C, M, kernel=kernel,
                            **cand)
        if backend == "cuda_fused":
            blk["c_unroll"] = fused_variant(
                fmt, khh * kww * C, conv_kw.get("extended", False),
                rounding, conv_kw.get("relu", False), cand.get("c_unroll"))[1]
        key = tuple(sorted(blk.items()))
        if key in results:
            continue

        def run():
            hobflops_conv2d(images, kernels, fmt=fmt, backend=backend,
                            device=device, rounding=rounding, **cand,
                            **conv_kw)
        try:
            run()                                   # build + warm
            _build.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                run()
            _build.synchronize(device)
            dt = (time.perf_counter() - t0) / iters
        except _LAUNCH_ERRORS as e:                 # unlaunchable combo
            last_err, last_cand = e, dict(cand)
            continue
        results[key] = dt
        if dt < best_dt:
            best, best_dt = dict(cand), dt
    if best is None:
        raise RuntimeError(
            "tune_conv_blocks: no candidate launched; last failing "
            f"candidate {last_cand!r} raised "
            f"{type(last_err).__name__}: {last_err}") from last_err
    return best, results
