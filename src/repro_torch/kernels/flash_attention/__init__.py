"""Blockwise (flash) attention, forward and backward: the reference's
``_flash`` (computed with ``jnp``; no TPU kernel) as the operators
``repro_torch::flash_fwd``/``flash_bwd`` in ``ops``, the CUDA kernels'
wrappers in ``kernel``, the plain versions in ``ref``."""
