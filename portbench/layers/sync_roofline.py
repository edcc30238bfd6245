"""sync_roofline: the whole sync_scan call (the next-match maps and
kernel S1, whatever implements them) against the least time for its
function on each call's shapes (bounds.sync_bound), over the call's
device time in the profiled sub-window (the kernels launched inside its
annotation), %."""
from portbench import bounds

CALLS = {"sync": [("tetra_tpu_torch.fastpath", "sync_scan")]}


def read(ctx):
    p = ctx.prof
    if not p:
        return None
    times = p["annotated"].get("sync", [])
    calls = p["args"].get("sync", [])
    t = sum(times)
    if t <= 0 or len(times) != len(calls):
        return None
    need = 0.0
    for a, k in calls:
        bits = a[0]
        steps = int(a[7])
        tol = int(a[9]) if len(a) > 9 else int(k.get("tol", 0))
        need += bounds.sync_bound(int(bits.shape[0]), int(bits.shape[1]),
                                  steps, tol)
    return 100.0 * need / t
