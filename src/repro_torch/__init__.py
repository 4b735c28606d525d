"""PyTorch/CUDA port of the HOBFLOPS bitslice-parallel CNN inference path.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  The
synthesis front end (``core.fpformat``/``circuit``/``blocks``/``fpcore``/
``opt``) is a copy of the reference's, so both packages build the same
netlists; the bitslice MAC runs in two hand-written CUDA kernels for
Hopper (``kernels.bitslice_mac`` and ``core.fused_backend``), built with
``nvcc`` at first use into ``build/kernels/``.
"""
