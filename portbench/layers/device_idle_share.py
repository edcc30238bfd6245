"""device_idle_share: the share of the profiled sub-window in which no
kernel, copy or set ran on the device (torch.profiler, the union of the
device's intervals), %."""


def read(ctx):
    p = ctx.prof
    if not p or p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
