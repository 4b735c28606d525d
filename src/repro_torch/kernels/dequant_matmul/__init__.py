"""The fused bitplane-dequant matmul (TPU kernel #3 of the reference):
``ops.dequant_matmul`` over ``pack_weights`` tensors, the CUDA kernel in
``kernel``, the plain version in ``ref``."""
