"""Plain reference of a HOBFLOPS conv stack served to a client.

Each image is encoded into the first layer's format (round to nearest
even), every layer pads its input with the +0 code (SAME, the low half
first), and each output pixel folds its ``kh * kw * cin`` products in
channel order, ``(kh, kw, cin)`` row-major, as the paper's convolution
does::

    acc = +0;  for each tap t:  acc = add(mul(x[t], w[t]), acc)

with the multiply rounding into the accumulator format and the add done
there.  ReLU (sign bit set -> +0) follows a conv that asks for it; the
next layer casts the accumulator codes down to its own format; the last
layer's codes decode to float32.  One chain step covers every image,
pixel and output channel at once, on the device the tensors are on.
Where the accumulator's code words are at most :data:`TABLE_BITS` wide
(hobflops9: 12 bits), ``mul`` and ``add`` are looked up in tables that
hold their value for every pair of codes, computed once by the same
functions.

Imports nothing of the program: the arithmetic is ``softfloat`` beside
this file.
"""
from __future__ import annotations

import functools

import torch

from . import softfloat as sf

TABLE_BITS = 12            # widest code word the lookup tables cover


def code_bits(f: sf.Fmt) -> int:
    """Width of a code word: exception (2), sign, exponent, fraction."""
    return f.w_e + f.w_f + 3


@functools.lru_cache(maxsize=4)
def tables(fi: sf.Fmt, device: torch.device):
    """(mul, add): ``mul[a << code_bits(fi) | b] = sf.mul(a, b, fi, fo)``
    and ``add[p << code_bits(fo) | q] = sf.add(p, q, fo)`` over every
    pair of code words, ``fo = fi.acc()``."""
    fo = fi.acc()

    def table(fn, bits):
        codes = torch.arange(1 << bits, dtype=torch.int32, device=device)
        rows = [fn(codes[a:a + 256, None], codes[None, :])
                for a in range(0, 1 << bits, 256)]
        return torch.cat(rows).reshape(-1)

    return (table(lambda a, b: sf.mul(a, b, fi, fo), code_bits(fi)),
            table(lambda a, b: sf.add(a, b, fo), code_bits(fo)))


def same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) SAME padding of one axis."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_codes(x, w, fi: sf.Fmt, stride: int = 1, relu: bool = False,
               lookup: bool = True):
    """x: [N, H, W, C] ``fi`` codes; w: [kh, kw, C, M] ``fi`` codes ->
    [N, Ho, Wo, M] accumulator codes.  ``lookup`` uses :func:`tables`
    where the format fits them."""
    n, h, wd, c = x.shape
    kh, kw, _, m = w.shape
    fo = fi.acc()
    ph, pw = same_pad(h, kh, stride), same_pad(wd, kw, stride)
    xp = torch.zeros((n, h + sum(ph), wd + sum(pw), c), dtype=torch.int32,
                     device=x.device)
    xp[:, ph[0]:ph[0] + h, pw[0]:pw[0] + wd] = x
    ho = (h + sum(ph) - kh) // stride + 1
    wo = (wd + sum(pw) - kw) // stride + 1
    acc = torch.zeros((n, ho, wo, m), dtype=torch.int32, device=x.device)
    bi, bo = code_bits(fi), code_bits(fo)
    t_mul, t_add = (tables(fi, x.device) if lookup and bo <= TABLE_BITS
                    else (None, None))
    for i in range(kh):
        for j in range(kw):
            win = xp[:, i:i + (ho - 1) * stride + 1:stride,
                     j:j + (wo - 1) * stride + 1:stride, :]
            for ch in range(c):
                if t_mul is None:
                    prod = sf.mul(win[..., ch:ch + 1], w[i, j, ch], fi, fo)
                    acc = sf.add(prod, acc, fo)
                else:
                    prod = t_mul[(win[..., ch:ch + 1] << bi) | w[i, j, ch]]
                    acc = t_add[(prod << bo) | acc]
    return sf.relu(acc, fo) if relu else acc


def stack_forward(images: torch.Tensor, kernels, layers, fmt: sf.Fmt):
    """images: [N, H, W, C] float32; kernels: float32 [kh, kw, cin, cout]
    tensors; layers: dicts with ``stride`` and ``relu``.  Every layer
    computes in ``fmt`` -> float32 [N, Ho, Wo, M]."""
    x, cur = sf.encode_f32(images, fmt), fmt
    for k, spec in zip(kernels, layers):
        if cur != fmt:
            x = sf.cast(x, cur, fmt)
        x = conv_codes(x, sf.encode_f32(k, fmt), fmt,
                       stride=spec.get("stride", 1),
                       relu=spec.get("relu", True))
        cur = fmt.acc()
    return sf.decode_f32(x, cur)
