"""Oracles for the HOBFLOPS convolution (test references only)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import softfloat as sf
from repro_torch.core.fpformat import RNE, FPFormat
from repro_torch.kernels.bitslice_mac.ref import hobflops_matmul_ref

from .ops import _conv_pad, im2col


def conv2d_f32(images, kernels, stride: int = 1,
               padding: str = "SAME") -> torch.Tensor:
    """Plain float32 conv oracle, NHWC x HWIO -> NHWC, on the device of
    ``images`` when it is a tensor.  SAME pads split low-half-first, as
    XLA does.  Both TF32 switches are held off for the call: cuDNN runs
    float32 convolutions in TF32 by default, which keeps only about
    three decimal digits."""
    x = torch.as_tensor(images, dtype=torch.float32)
    k = torch.as_tensor(kernels, dtype=torch.float32, device=x.device)
    kh, kw = k.shape[:2]
    pad_h, pad_w = _conv_pad(x.shape[1], x.shape[2], kh, kw, stride,
                             padding)
    x = F.pad(x.permute(0, 3, 1, 2),
              (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = F.conv2d(x, k.permute(3, 2, 0, 1), stride=stride)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    return out.permute(0, 2, 3, 1)


def hobflops_conv2d_ref(images, kernels, fmt: FPFormat, stride: int = 1,
                        padding: str = "SAME", extended: bool = False,
                        rounding: str = RNE, relu: bool = False):
    """Sequential HOBFLOPS conv oracle via im2col + code-level MAC
    (numpy in, numpy out)."""
    kh, kw, C, M = np.shape(kernels)
    patches = im2col(torch.as_tensor(np.asarray(images, np.float32)), kh, kw,
                     stride, padding).numpy().astype(np.float64)
    B, Ho, Wo, K = patches.shape
    ic = sf.encode(patches.reshape(-1, K), fmt, rounding)
    wc = sf.encode(np.asarray(kernels, np.float64).reshape(K, M), fmt,
                   rounding)
    out_codes = hobflops_matmul_ref(ic, wc, fmt, extended, rounding)
    fmt_out = fmt.mult_out(extended)
    vals = sf.decode(out_codes, fmt_out)
    if relu:
        vals = np.maximum(vals, 0.0)
    return vals.reshape(B, Ho, Wo, M)
