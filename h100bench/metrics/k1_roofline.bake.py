"""K1's share of its roofline on a batch's stack: the Gauss chain's counted
operations and bytes (``costs/k1.py``) over the device time of K1's
``chain_tile`` launches, however many a chain takes."""

from h100bench.costs import k1
from h100bench.reference.kernels import limit_width
from h100bench.roofline import share


def read(tr):
    f, res = tr.config["field"], tr.config["tile"]["generator_res"]
    ops, nbytes = k1.cost(tr.traffic["block"] ** 2 * res * res, limit_width(f["blur_width"]),
                          f["blur_iterations"])
    return share(tr, lambda n: "::chain_tile<" in n, ops, nbytes)
