"""Device operations (kernels, copies, fills) in the profiled sub-window
over the training steps it holds (one whole epoch: its upload and
evaluation included)."""


def read(tr):
    if not tr.steps or not tr.device_ops:
        return None
    return len(tr.device_ops) / tr.steps
