"""Edge detection — port of ``noize_tpu.ops.edge`` (EdgeDetection.cs:22-85,
EdgeJob.cs:10-47): the Sobel / Prewitt taps selectable by (algorithm,
direction), and the 2-D magnitude √(H² + V²) of the two 1-D passes.  On
the card a 1-D pass is a K1 call (``kernels.kernel_filter``'s route) and
the 2-D magnitude one K1@rss launch."""

from __future__ import annotations

from .kernels import (
    _PREWITT3_HX, _PREWITT3_HZ, _PREWITT3_VX, _PREWITT3_VZ,
    _SOBEL3_HX, _SOBEL3_HZ, _SOBEL3_VX, _SOBEL3_VZ,
    _chain,
)
from .cuda.stencil import root_sum_squares_chain

EDGE_ALGORITHMS = ("SOBEL", "PREWITT")
EDGE_DIRECTIONS = ("HORIZONTAL", "VERTICAL")

_KERNELS = {
    ("SOBEL", "HORIZONTAL"): (_SOBEL3_HX, _SOBEL3_HZ),
    ("SOBEL", "VERTICAL"): (_SOBEL3_VX, _SOBEL3_VZ),
    ("PREWITT", "HORIZONTAL"): (_PREWITT3_HX, _PREWITT3_HZ),
    ("PREWITT", "VERTICAL"): (_PREWITT3_VX, _PREWITT3_VZ),
}


def _taps(algorithm, direction):
    try:
        return _KERNELS[(algorithm, direction)]
    except KeyError:
        raise ValueError(
            f"unknown edge kernel ({algorithm!r}, {direction!r}); "
            f"algorithms {EDGE_ALGORITHMS}, directions {EDGE_DIRECTIONS}"
        )


def edge_1d(a, algorithm: str = "SOBEL", direction: str = "HORIZONTAL"):
    """Edge1DFilter.Schedule: one separable X/Z series with the selected
    taps (EdgeJob.cs:11-20)."""
    tx, tz = _taps(algorithm, direction)
    return _chain(a, tx, tz, 1.0, 1)


def edge_2d(a, algorithm: str = "SOBEL"):
    """Edge2DFilter.Schedule: H and V passes on the same input combined by
    √(H² + V²) (EdgeJob.cs:33-37 → ScheduleReduce<RootSumSquaresTiles>);
    one K1@rss launch on the card."""
    return root_sum_squares_chain(a, _taps(algorithm, "HORIZONTAL"),
                                  _taps(algorithm, "VERTICAL"))
