"""K10's share of its roofline in a batch of tiles: the fBm's counted
operations and bytes (``costs/k10.py``) over K10's device time, one
launch a batch."""

from h100bench.costs import k10
from h100bench.roofline import share


def read(tr):
    f, res = tr.config["field"], tr.config["tile"]["generator_res"]
    ops, nbytes = k10.cost(tr.traffic["block"] ** 2 * res * res, f["noise_type"], f["octaves"])
    return share(tr, lambda n: "::fractal<" in n, ops, nbytes, 1)
