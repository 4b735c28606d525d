"""HOBFLOPS weight quantization for the LM stack.

Storage layouts for custom-precision FP weights (the paper's "fast
custom-precision FP ... valuable in cases where memory bandwidth is
limited"):

* ``"native"``     — one code per int8/int16 element; rounds the
                     footprint up to the container width.
* ``"bitplane"``   — the paper's bitslice layout: exactly ``nbits`` bits
                     per weight in device memory (e.g. 9 bits for
                     HOBFLOPS9), at a higher dequant cost.
* ``"bitplane2d"`` — the same bits as ``[nbits, K, N/32]`` planes of a
                     ``[K, N]`` matrix, the layout the dequant matmul
                     kernel streams (``kernels.dequant_matmul``).
"""
from .storage import (LANE, QuantizedTensor, dequantize, quantize,
                      storage_bytes)
from .apply import (abstract_quantize_params, make_deq, quantize_params,
                    quantized_bytes, quantized_pspecs)

__all__ = ["LANE", "QuantizedTensor", "quantize", "dequantize",
           "storage_bytes", "quantize_params", "make_deq",
           "quantized_bytes", "abstract_quantize_params",
           "quantized_pspecs"]
