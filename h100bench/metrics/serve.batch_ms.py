"""The median batch's run, ms: the window's ``serve.batch`` spans, each a
``tile_batch`` and the wait on its CUDA event (the program's spans,
``h100bench/spans.py``)."""

import numpy as np

from h100bench import spans


def read(tr):
    s = spans.of(tr)
    ms = spans.durations_ms(s, "serve.batch") if s is not None else []
    return float(np.median(ms)) if ms else None
