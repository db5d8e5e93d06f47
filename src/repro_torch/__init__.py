"""PyTorch/CUDA port of the MLS low-bit training framework.

Runs the JAX package's low-bit training math (paper Alg. 1 and 2, Eq. 6-8)
on PyTorch, with the quantize and quantized-domain GEMM kernels written by
hand in CUDA C++ for Hopper (``kernels/csrc``).  Imports no JAX.
"""
