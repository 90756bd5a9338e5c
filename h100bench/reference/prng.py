"""Frozen copy, for the benchmark's reference, of ``noize_tpu_torch.prng``, the plain
hash only (no K8).  JAX's threefry2x32 PRNG in PyTorch: ``PRNGKey``, ``split``,
``fold_in`` and ``randint`` give the bits ``jax.random`` gives with its
default implementation (``jax_default_prng_impl=threefry2x32``) and
``jax_threefry_partitionable=True``, the setting of current JAX releases.

A key is a ``torch.uint32`` tensor of shape ``(2,)`` on a device; every
draw runs there.  PyTorch's ``uint32`` has no shifts or adds on the CPU,
so the arithmetic runs in ``int64`` on values in [0, 2³²), masked after
each add and rotate.

What the partitionable setting selects (``jax/_src/prng.py``):

  * a draw of ``shape`` hashes the 64-bit counters 0 .. size−1, split into
    (high word, low word), with the key: ``threefry2x32(k, (hi, lo))``;
    32-bit random bits are the two output words XORed;
  * ``split(key, num)`` hashes the counters 0 .. num−1 the same way and
    returns the output word pairs as the new keys (the "foldlike" split);
  * ``fold_in(key, data)`` hashes the one block (0, data).

On CPU tensors the hash is about 170 elementwise int64 tensor ops
whatever its size (``_threefry2x32_plain``).  On the card it is K8
(``csrc/threefry.cu``): one launch a hash, one thread an output pair, the
rounds in uint32 registers; and ``randint`` — with the spawn's outer
``split`` too (``_randint_of_split``) — is K8's draw entry, one launch that
derives each output's leaf key, hashes its counter and combines the two
halves.  Either way a stack of keys draws in one pass (``randint`` draws
both of its halves at once, ``erosion.particles.spawn`` both coordinates).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def _rotl(v, r: int):
    return ((v << r) & _MASK) | (v >> (32 - r))


def _threefry2x32_plain(key, x0, x1):
    """The plain version of K8: the rounds as int64 tensor operations."""
    k = key.to(torch.int64)
    k0, k1 = k[..., 0, None], k[..., 1, None]
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _broadcast(*shapes) -> tuple:
    """The broadcast of ``shapes`` (``torch.broadcast_shapes`` imports the
    symbolic-shape machinery on its first call, seconds of host time)."""
    nd = max(len(s) for s in shapes)
    out = []
    for d in range(nd):
        sizes = {s[d - nd + len(s)] for s in shapes if d - nd + len(s) >= 0} - {1}
        if len(sizes) > 1:
            raise ValueError(f"threefry2x32: shapes {shapes} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def threefry2x32(key, x0, x1):
    """The 20-round Threefry-2x32 hash of the counter words ``(x0, x1)``
    (int64 tensors, values in [0, 2³²)) under ``key`` (uint32 (2,), or a
    stack (..., 2) whose leading dims broadcast against the counters' all
    but last); returns the two output words (int64), as
    ``_threefry2x32_lowering`` does.  A CPU key takes the plain version; a
    CUDA key launches K8 (one launch) or raises."""
    return _threefry2x32_plain(key, x0, x1)


def _counters(size: int, device):
    lo = torch.arange(size, dtype=torch.int64, device=device)
    return lo >> 32, lo & _MASK


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: the key (0, the
    seed's low 32 bits); a negative seed is its two's complement."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("PRNGKey(device='cuda'): no CUDA device")
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.uint32, device=device)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``num`` new keys, shape (num, 2);
    a stack of keys (..., 2) gives (..., num, 2), each key's split."""
    hi, lo = _counters(int(num), key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.stack([b0, b1], dim=-1).to(torch.uint32)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key for the 32-bit ``data``."""
    x = torch.tensor([0, int(data) & _MASK], dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, x[:1], x[1:])
    return torch.cat([b0, b1]).to(torch.uint32)


def fold_in_stack(key, data) -> torch.Tensor:
    """``fold_in`` of each of the T 32-bit ``data`` into ``key`` — one key,
    or a stack (T, 2) whose i-th key takes ``data[i]`` — as ``jax.vmap`` of
    ``fold_in`` gives them: keys (T, 2), in one hash."""
    d = torch.tensor([int(v) & _MASK for v in data], dtype=torch.int64, device=key.device)
    if key.dim() > 1:
        d = d[:, None]
    b0, b1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([b0.reshape(-1), b1.reshape(-1)], -1).to(torch.uint32)


def random_bits(key, shape) -> torch.Tensor:
    """32 random bits a cell (int64 values in [0, 2³²)), as
    ``jax.random.bits(key, shape, uint32)``; a stack of keys (..., 2)
    gives (..., *shape), each key's draw, in one hash."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    hi, lo = _counters(size, key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def _span(minval, maxval):
    """randint's bounds: (lo, span, mult) as ``jax._src.random._randint``
    combines the halves, span = (hi - lo) mod 2³² (1 when hi <= lo) and
    mult = (2¹⁶ mod span)² mod span.  Bounds outside int32 raise, as JAX's
    do without 64-bit mode."""
    lo, hi = int(minval), int(maxval)
    if not (_INT32_MIN <= lo <= _INT32_MAX and _INT32_MIN <= hi <= _INT32_MAX):
        raise OverflowError(f"randint: bounds ({lo}, {hi}) outside int32")
    span = (hi - lo) & _MASK if hi > lo else 1
    mult = (1 << 16) % span
    return lo, span, ((mult * mult) & _MASK) % span


def _randint_composed(key, shape, minval, maxval) -> torch.Tensor:
    """``randint`` as the hash and int64 tensor operations: two 32-bit
    draws (``random_bits`` of ``split(key)``) combined modulo the span in
    uint32 arithmetic that wraps.  The plain version of K8's draw entry on
    CPU tensors (on CUDA tensors its hashes are K8 launches)."""
    lo, span, mult = _span(minval, maxval)
    bits = random_bits(split(key), shape)  # (..., 2, *shape): both halves at once
    nd = len(tuple(shape))
    higher, lower = bits.unbind(dim=bits.dim() - nd - 1)
    offset = (((higher % span) * mult) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    # uint32 -> int32 wraps, and so does the int32 add
    offset = torch.where(offset > _INT32_MAX, offset - (1 << 32), offset)
    out = lo + offset
    out = torch.where(out > _INT32_MAX, out - (1 << 32), out)
    return out.to(torch.int32)


def randint(key, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with its default
    int32 dtype: two 32-bit draws (from ``split(key)``) combined modulo
    the span as ``jax._src.random._randint`` does, in uint32 arithmetic
    that wraps; ``maxval <= minval`` returns ``minval``.  Bounds outside
    int32 raise, as JAX's do without 64-bit mode.  A stack of keys
    (..., 2) gives (..., *shape), each key's draw (``jax.vmap``), in the
    same pass as one key.  A CPU key takes the plain version
    (``_randint_composed``); a CUDA key launches K8's draw entry (one
    launch) or raises."""
    return _randint_composed(key, shape, minval, maxval)


def _randint_of_split(key, shape, minval, maxval, dtype=torch.int32) -> torch.Tensor:
    """``randint(split(key), shape, minval, maxval).to(dtype)``: the
    draws of both halves of ``split(key)``, (..., 2, *shape) — the spawn's
    two coordinates.  One K8 launch on the card."""
    return _randint_composed(split(key), shape, minval, maxval).to(dtype)
