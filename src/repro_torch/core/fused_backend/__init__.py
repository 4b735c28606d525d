"""Fused netlist compiler backend for Hopper.

Lowers a whole optimized netlist — the K-step MAC chain — into the
straight-line body of one CUDA kernel: the ``_slot_schedule`` register
allocation becomes a file of ``uint32_t`` locals held in registers,
every gate one C expression, and the ReLU epilogue runs in the kernel
after the channel loop.  Selected as ``backend="cuda_fused"`` in
``conv_core`` / ``NetworkGraph``; bit-identical to the interpreter
backend and the softfloat oracle.
"""
from .emitter import LoweredNetlist, RegisterFileOverflow, lower_netlist
from .kernel import (fused_chain_k, fused_chain_lowered, fused_mac_cuda,
                     fused_variant)

__all__ = [
    "LoweredNetlist", "RegisterFileOverflow", "lower_netlist",
    "fused_chain_lowered", "fused_mac_cuda", "fused_chain_k",
    "fused_variant",
]
