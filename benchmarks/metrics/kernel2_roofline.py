"""Kernel 2's (``csrc/pooled_query.cu``, with its select) share of its
roofline: every call's least time (``counts.kernel2_bound_s``) over the
kernel's device time in the trace, in %."""

from benchmarks import counts
from benchmarks.drivers.common import model_dims

KERNELS = ("wg_kernel", "struct_rows_kernel", "select_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = sum(v for k, v in tr["device_s"].items() if any(n in k for n in KERNELS))
    if busy <= 0:
        return None
    c = ctx["counters"]
    d, h, s, k = model_dims(ctx["config"])
    return 100.0 * c["calls"] * counts.kernel2_bound_s(c["queries"], c["candidates"], d, h, s, k) / busy
