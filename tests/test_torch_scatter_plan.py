"""K9's sort plan (``noize_tpu_torch.erosion.scatter_cuda.sort_plan``,
``scratch_words``) on the CPU.

The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``, bit-equal to the CPU's
``scatter_events`` at the plan's pass edges); this holds the plan it is
given and the scratch it is handed.
"""

import pytest

from noize_tpu_torch.erosion import scatter_cuda as SCU


@pytest.mark.parametrize("size,bits,passes,digit", [
    (1, 1, 1, 1), (2, 1, 1, 1), (3, 2, 1, 2), (2**11, 11, 1, 11), (2**11 + 1, 12, 2, 6),
    (2048 * 2048, 22, 2, 11), (2**22 + 1, 23, 3, 8), (2049 * 2049, 23, 3, 8),
    (2**31 - 2, 31, 3, 11)])
def test_sort_plan_sorts_only_the_bits_size_needs(size, bits, passes, digit):
    """ceil(log2 size) key bits (at least one), the fewest passes of at most
    11 bits, spread evenly: two passes of 11 at 2048²; every cell fits."""
    got = SCU.sort_plan(size, 104_000)
    assert got == (bits, passes, digit, -(-104_000 // SCU.TILE_EVENTS))
    assert digit <= SCU.DIGIT_BITS and passes * digit >= bits
    assert (size - 1) >> (passes * digit) == 0


@pytest.mark.parametrize("size,n,passes,digit", [
    (2048 * 2048, 262_144, 2, 11), (2048 * 2048, 262_145, 3, 8), (2048 * 2048, 524_288, 3, 8),
    (2049 * 2049, 524_288, 3, 8), (2**11, 10**6, 2, 6), (2, 10**6, 1, 1)])
def test_sort_plan_narrows_its_digits_past_many_tiles(size, n, passes, digit):
    """Past 128 tiles (262,144 events) a pass takes at most 8 bits: three
    passes at 2048² for the vegetation's 524,288 stamps, two of 11 up to
    128 tiles."""
    tiles = -(-n // SCU.TILE_EVENTS)
    assert SCU.sort_plan(size, n) == ((size - 1).bit_length(), passes, digit, tiles)
    assert digit <= (SCU.DIGIT_BITS if tiles <= SCU.MANY_TILES else SCU.MANY_TILES_DIGIT_BITS)
    assert (size - 1) >> (passes * digit) == 0


@pytest.mark.parametrize("n,maps,tiles,words", [
    (1, 1, 1, 9 + 2 * 2049), (2048, 3, 1, 9 * 2048 + 2 * 2049),
    (2049, 3, 2, 9 * 2049 + 3 * 2049), (104_000, 3, 51, 9 * 104_000 + 52 * 2049),
    (524_288, 4, 256, 11 * 524_288 + 257 * 2049)])
def test_scratch_words_hold_the_kernels_buffers(n, maps, tiles, words):
    """Two buffers of records (four words each), the first pass's keys, two
    of the fourth map's deltas, a row of bucket counts a tile of 2048
    events and the buckets' totals."""
    assert SCU.TILE_EVENTS == 2048
    assert SCU.sort_plan(2048 * 2048, n)[3] == tiles
    assert SCU.scratch_words(n, 11, maps) == words
