"""K2's share of its roofline on a batch's stack: the flow map's counted
operations and bytes (``costs/k2.py``) over the device time of K2's
``flow_tile`` launches, however many a map takes."""

from h100bench.costs import k2
from h100bench.roofline import share


def read(tr):
    f, res = tr.config["field"], tr.config["tile"]["generator_res"]
    ops, nbytes = k2.cost(tr.traffic["block"] ** 2 * res * res, f["flow_iterations"])
    return share(tr, lambda n: "::flow_tile(" in n, ops, nbytes)
