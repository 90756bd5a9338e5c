"""The 95th percentile of the orders' wait in the server's queue, ms: the
window's ``serve.queue`` spans, each from ``submit`` to the start of the
batch that takes the order (the program's spans, ``h100bench/spans.py``)."""

import numpy as np

from h100bench import spans


def read(tr):
    s = spans.of(tr)
    ms = spans.durations_ms(s, "serve.queue") if s is not None else []
    return float(np.percentile(ms, 95)) if ms else None
