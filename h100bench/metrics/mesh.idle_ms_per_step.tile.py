"""The device's idle time a step, ms, in gaps whose middle lies in a
``mesh`` span, over the window's ``step`` spans (the program's spans,
``h100bench/spans.py``)."""

from h100bench import spans


def read(tr):
    return spans.idle_ms_per(tr, lambda n: n == "mesh", "step")
