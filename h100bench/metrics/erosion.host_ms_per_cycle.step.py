"""The host's time a cycle, ms: the mean length of the window's
``erosion.cycle`` spans (the program's spans, ``h100bench/spans.py``)."""

import numpy as np

from h100bench import spans


def read(tr):
    s = spans.of(tr)
    ms = spans.durations_ms(s, "erosion.cycle") if s is not None else []
    return float(np.mean(ms)) if ms else None
