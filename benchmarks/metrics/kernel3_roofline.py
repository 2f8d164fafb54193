"""Kernel 3's (``csrc/per_question_topk.cu``) share of its roofline: the
least time of the kernel-routed groups' real edges (``counts.
kernel3_bound_s``, one launch per group) over the kernel's device time in
the trace, in %.  The groups are re-derived as ``serving.serve_split``
forms them: a request's questions sorted by edge count, cut into groups of
``group_size``, each padded to the power of two that holds its edges, k and
its nodes plus one; groups from ``fused_threshold`` up take the kernel
(both as the run served them: ``drivers.serve.engine_options``)."""

from benchmarks import counts
from benchmarks.drivers.common import model_dims

KERNELS = ("wg_kernel", "struct_rows_kernel", "select_kernel")


def _pow2(n: int, lo: int = 8) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = sum(v for k, v in tr["device_s"].items() if any(n in k for n in KERNELS))
    if busy <= 0:
        return None
    d, h, s, k = model_dims(ctx["config"])
    c = ctx["counters"]
    size, thr, sizes = int(c["group_size"]), int(c["fused_threshold"]), c["sizes"]
    least = 0.0
    for req in c["requests"]:
        order = sorted(req, key=lambda i: sizes[i][0])
        for g0 in range(0, len(order), size):
            grp = order[g0:g0 + size]
            m = max(_pow2(max(sizes[i][0] for i in grp)), _pow2(k), _pow2(max(sizes[i][1] for i in grp) + 1))
            if m >= thr:
                least += counts.kernel3_bound_s([sizes[i][0] for i in grp], m, d, h, s, k)
    return 100.0 * least / busy if least > 0 else None
