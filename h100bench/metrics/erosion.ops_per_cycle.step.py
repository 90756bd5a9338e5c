"""Device operations (kernels, copies, fills) in the profiled window over
the erosion cycles the program ran in it (``torch.profiler``)."""


def read(tr):
    if not tr.cycles or not tr.device_ops:
        return None
    return len(tr.device_ops) / tr.cycles
