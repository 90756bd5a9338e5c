"""Wrappers of the hand-written CUDA kernels K1-K3 (K4 lives in
``erosion.pool_cuda``)."""
