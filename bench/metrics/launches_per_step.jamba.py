"""Device operations (kernels, copies, fills) in the profiled sub-window
over the training steps it holds (one whole step)."""


def read(tr):
    if not tr.steps or not tr.device_ops:
        return None
    return len(tr.device_ops) / tr.steps
