"""k1_ms.sweep: device milliseconds a design of the sweep spends in the
trace kernel (``persistent_trace_kernel`` in the profiler's trace)."""


def read(ctx):
    t = ctx.roofline("persistent_trace").kernel_seconds(
        ctx.trace.get("kernels", {}))
    if not t or not ctx.designs:
        return None
    return t * 1e3 / ctx.designs
