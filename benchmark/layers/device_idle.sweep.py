"""device_idle.sweep: the share of the traced window in which no kernel,
copy or fill ran on the card (``torch.profiler``), in percent."""


def read(ctx):
    tr = ctx.trace
    if not tr or tr.get("window_s", 0) <= 0 or tr.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
