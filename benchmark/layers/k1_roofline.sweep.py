"""k1_roofline.sweep: the trace kernel's least time on the card
(``roofline/persistent_trace.py``) over its time in the profiler's trace,
in percent."""


def read(ctx):
    roof = ctx.roofline("persistent_trace")
    t = roof.kernel_seconds(ctx.trace.get("kernels", {}))
    d = ctx.data
    if not t or "edge_bounces" not in d or not d.get("launches"):
        return None
    w = ctx.config["workload"]
    least, _ = roof.least_seconds(
        designs=ctx.designs,
        cells_per_design=w["wavelengths"] * w["num_fov_x"] * w["num_fov_y"],
        slots=w["slots"], bins=w["eyebox_bins"][0] * w["eyebox_bins"][1],
        launches=d["launches"], edge_bounces=d["edge_bounces"],
        deposits=d["deposits"])
    return 100.0 * least / t
