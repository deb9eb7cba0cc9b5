"""eval_ms.sweep: device milliseconds a design of the sweep spends in the
Wald factors, the efficiency sums and the pupil integration
(``SweepResult.timings["reduce_ms"]``, CUDA events)."""


def read(ctx):
    if not ctx.records or any("reduce_ms" not in r["timings"]
                              for r in ctx.records):
        return None
    return sum(r["timings"]["reduce_ms"] for r in ctx.records) / ctx.designs
