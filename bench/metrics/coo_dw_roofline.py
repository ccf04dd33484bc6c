"""Kernel F's (with G's epilogue) share of its roofline over the profiled
epoch: the sum of each launch's bound (``counts/coo_dw.py``, f32 peak)
over the profiler's device time of F's launches, in %. Silent where the
profile holds another number of launches than the epoch's count."""
from bench.counts import bound_s, set_mlp

KERNEL = r"coo_dw_kernel"


def read(tr):
    launches = set_mlp.epoch_launches(tr.info)["coo_dw"] * tr.units
    secs, n = tr.kernel_seconds(KERNEL)
    if n == 0 or n != len(launches):
        return None
    return 100.0 * sum(bound_s(b, f) for b, f in launches) / secs
