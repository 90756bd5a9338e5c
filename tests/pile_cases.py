"""Exact pile solver cases (``EXACT_PILES``) at the edges of K6's design,
shared by the CPU parity tests (``test_torch_piles.py``, against
``noize_tpu``) and the card tests (``test_torch_kernels_cuda.py``, K6 and
its table entry against their plain versions).  NumPy only: the card's
machine has no JAX.

K6 deposits whole increments in parallel until the amount left would fall
below one increment, then runs the rest (the tail) one deposit at a time,
and ends a sweep once nothing is left; the cases put a pile's end at each
of those points.
"""

import numpy as np

HS = 1000.0
INC = np.float32(1.0 / HS)  # MIN_PILE_INCREMENT / HEIGHT at the defaults


def height(res, seed):
    return np.random.default_rng(seed).uniform(0.2, 0.8, (res, res)).astype(np.float32)


def pile_map(res, cells, vols):
    m = np.zeros((res, res), np.float32)
    for (r, c), v in zip(cells, vols):
        m[r, c] = v
    return m


def whole_increments(n, inc=INC):
    """n increments placed, summed one float32 add at a time."""
    placed = np.float32(0.0)
    for _ in range(n):
        placed = np.float32(placed + inc)
    return placed


def handle_cases():
    """One pile on ``height(32, radius + r0)``: name -> (radius, r0, c0,
    amount, increment, eager), eager where JAX runs the case one primitive
    at a time (a few hundred visits at most)."""
    third = np.float32(1.0 / 3000.0)  # not a float32 of its own: 1/3000 rounds
    return {
        # the first five are named radius-r0-c0-amount-eager
        "2-0-1-0.03-True": (2, 0, 1, 0.03, INC, True),  # at the border, several sweeps
        "4-20-17-0.4-False": (4, 20, 17, 0.4, INC, False),  # several sweeps
        "4-0-1-0.05-False": (4, 0, 1, 0.05, INC, False),  # out-of-grid slots skipped
        "15-31-30-0.03-False": (15, 31, 30, 0.03, INC, False),  # near the far corner
        "15-12-9-2.0-False": (15, 12, 9, 2.0, INC, False),
        # 12 whole deposits, then a partial one at slot 8 of round 2's 20
        "partial-mid-round": (2, 9, 11, 0.0123456, INC, True),
        # 12 whole increments: the whole deposits end with exactly 0 left
        "whole-increments": (4, 20, 17, whole_increments(12), INC, False),
        # 8 increments summed, but the 8th deposit of the sweep is not whole
        # (8 increments less 7 round below one): a tail of one
        "whole-increments-short-last": (4, 20, 17, whole_increments(8), INC, False),
        "many-sweeps": (2, 14, 5, 0.3, INC, False),  # 22 sweeps
        "inc-1over3000": (4, 16, 16, 0.05, third, False),  # 5 sweeps
        # a pile in each corner at radius 15: 50 whole deposits, then a tail
        "corner-r15-0-0": (15, 0, 0, 0.05, INC, False),
        "corner-r15-0-31": (15, 0, 31, 0.05, INC, False),
        "corner-r15-31-0": (15, 31, 0, 0.05, INC, False),
        "corner-r15-31-31": (15, 31, 31, 0.05, INC, False),
    }


def map_cases():
    """Piles on ``height(res, 7)`` in one call: name -> (cells, volumes,
    radius, height scale, res); the increment is 1 / height scale."""
    rng = np.random.default_rng(3)
    overlap = [(10, 10), (11, 12), (13, 9), (10, 14), (0, 5), (31, 31)]
    overlap_vols = [0.05, 0.08, 0.03, 0.12, 0.02, 0.04]
    # 90 piles, volumes in 5 tied levels: the 64 kept are the largest, ties
    # to the lower cell index
    flat = rng.choice(32 * 32, 90, replace=False)
    cells = [(int(f) // 32, int(f) % 32) for f in flat]
    vols = list(np.float32(0.01) * rng.integers(1, 6, 90).astype(np.float32))
    # a chain of three, each overlapping the next (7 apart, reach 5), among
    # piles that overlap none
    chain = [(20, 20), (20, 27), (20, 34), (50, 50), (5, 58), (58, 5), (44, 12)]
    chain_vols = [0.2, 0.05, 0.0123456, 0.03, whole_increments(12), 0.1, 0.004]
    # the corners and the middles of the borders at radius 15
    rim = [(0, 0), (0, 63), (63, 0), (63, 63), (0, 31), (31, 0), (63, 31), (31, 63)]
    rim_vols = [0.05, 0.02, 0.3, 0.0123456, 0.04, 0.07, 0.01, 0.15]
    return {
        "overlap-r4": (overlap, overlap_vols, 4, HS, 32),
        "many-ties-r2": (cells, vols, 2, HS, 32),
        "chain3-disjoint-r4": (chain, chain_vols, 4, HS, 64),
        "rim-r15": (rim, rim_vols, 15, HS, 64),
        "inc-1over3000-r4": (overlap, overlap_vols, 4, 3.0 * HS, 32),
    }
