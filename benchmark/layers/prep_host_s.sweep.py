"""prep_host_s.sweep: host seconds a design of the sweep spends on its
geometry and on its rows' host inputs (``SweepResult.timings``:
``prep_geometry_s`` + ``prep_host_rows_s``)."""

KEYS = ("prep_geometry_s", "prep_host_rows_s")


def read(ctx):
    if not ctx.records or any(k not in r["timings"] for r in ctx.records
                              for k in KEYS):
        return None
    return sum(r["timings"][k] for r in ctx.records for k in KEYS) / ctx.designs
