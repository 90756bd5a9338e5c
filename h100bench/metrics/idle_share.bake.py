"""The device's idle share of the profiled window, %: one less the union of
its operations' intervals over the window's length on the host clock
(``torch.profiler``)."""


def read(tr):
    if not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
