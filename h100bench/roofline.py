"""What the kernels' roofline readers share: the least time a kernel's
calls need (``peaks.bound_s`` of its counted operations and bytes) over
the device time of its launches in the profiled window, by name, %.  A
window whose launches are not a whole number a call (the profiler lost a
record) reads nothing."""

from . import peaks


def share(tr, match, ops: float, nbytes: float, launches_per_call: int = None):
    times = tr.kernels(match)
    if not times or not tr.calls:
        return None
    if launches_per_call is not None and len(times) != launches_per_call * tr.calls:
        return None
    if launches_per_call is None and len(times) % tr.calls:
        return None
    return 100.0 * peaks.bound_s(ops, nbytes) * tr.calls / sum(times)
