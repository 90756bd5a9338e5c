"""The union of the device's busy intervals in the profiled window, ms,
over the erosion cycles the program ran in it (``torch.profiler``)."""


def read(tr):
    if not tr.cycles or not tr.device_ops:
        return None
    return tr.busy_s() * 1e3 / tr.cycles
