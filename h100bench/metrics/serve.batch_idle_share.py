"""The share of the time inside the window's ``serve.batch`` spans that
the device's operations do not cover, %: the server's own batches leaving
the card idle (the program's spans, ``h100bench/spans.py``; the device's
operations, ``torch.profiler``)."""

from h100bench import spans


def read(tr):
    s = spans.of(tr)
    busy = spans.busy_share(tr, spans.named(s, "serve.batch")) if s is not None else None
    return None if busy is None else 100.0 * (1.0 - busy)
