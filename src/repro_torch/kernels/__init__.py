"""The port's kernels: the bitslice MAC interpreter
(``bitslice_mac``), the convolution/network path built on it and on
the fused backend (``conv2d_bitslice``), the fused bitplane-dequant
matmul of quantized LM weights (``dequant_matmul``), and blockwise
attention, forward and backward (``flash_attention``)."""
from __future__ import annotations


def build_kernels(fused_variants=()) -> list:
    """Build every CUDA kernel ahead of a run, one ``nvcc`` per source,
    started together: the interpreter, the dequant matmul, the
    blockwise attention, and one
    library holding every ``(fmt, k, extended, rounding, relu)`` fused
    variant listed (see ``NetworkGraph.fused_variants``) that no library
    loaded in this process holds yet.  A source built before is loaded
    without compiling.  Returns the loaded libraries, whose
    ``ptxas_log`` carries the ``-Xptxas -v`` report."""
    from repro_torch import _build
    from repro_torch.core.fused_backend import kernel as fused
    from repro_torch.kernels.bitslice_mac import kernel as interp
    from repro_torch.kernels.dequant_matmul import kernel as dq
    from repro_torch.kernels.flash_attention import kernel as fa

    variants = sorted({v for v in fused_variants if not fused.is_bound(v)},
                      key=lambda v: fused.variant_tag(*v))
    jobs = [interp.build_job(), dq.build_job(), fa.build_job()]
    if variants:
        jobs.append(fused.build_job(variants))
    libs = _build.build(jobs)
    interp.load(libs[0])
    dq.load(libs[1])
    fa.load(libs[2])
    if variants:
        fused.load(libs[3], variants)
    return libs
