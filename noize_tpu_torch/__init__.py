"""noize_tpu_torch — the PyTorch + CUDA port of ``noize_tpu``.

The package mirrors ``noize_tpu``'s module paths and function names, so
each function has an obvious counterpart in the JAX reference.  Plain
tensor code is PyTorch; the kernels that ``noize_tpu`` wrote in Pallas for
the TPU are hand-written CUDA C++ for Hopper (``csrc/``), built with nvcc
on first use and bound through ``ctypes`` (``_cuda.py``).

Every kernel wrapper has a plain PyTorch version beside it.  The wrapper
runs the plain version only when it is handed CPU tensors; on a CUDA
tensor it launches its kernel or raises.

Importing this package (or any of its modules) never imports ``jax``.
"""
