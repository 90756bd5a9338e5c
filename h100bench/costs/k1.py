"""K1, the iterated separable blur (``csrc/stencil.cu``): a multiply and an
add a tap a cell, two passes an iteration; the input read once and the
output written once."""


def cost(cells: int, taps: int, iterations: int):
    """(float32 ops, bytes) of a ``taps``-tap chain of ``iterations`` over
    ``cells`` cells."""
    return 2 * 2 * taps * iterations * cells, 8 * cells
