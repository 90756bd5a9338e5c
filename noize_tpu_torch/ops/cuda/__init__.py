"""Wrappers of the hand-written CUDA kernels K1-K3 and K10 (K4 lives in
``erosion.pool_cuda``)."""
