"""1 - (union of the device's kernel and copy intervals) / (the profiled
sub-window's wall seconds), over one whole training step, in %."""


def read(tr):
    if tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
