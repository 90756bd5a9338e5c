"""float32 arithmetic that rounds the way the reference does, on the CPU
and on the card alike."""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x):
    """Correctly rounded float32 square root.  PyTorch's vectorised CPU
    ``sqrt`` is off by one ulp on ~0.5% of float32 inputs (XLA's and CUDA's
    are exact); the float64 root rounded to float32 is exact everywhere."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def recip(c) -> float:
    """float32 reciprocal of a constant divisor: XLA's algebraic simplifier
    turns ``x / c`` into ``x * (1/c)`` in every compiled JAX program, and
    writing the product keeps the CPU and the card on the same bits."""
    return float(np.float32(1.0) / np.float32(c))
