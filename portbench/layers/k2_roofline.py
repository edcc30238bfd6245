"""k2_roofline: kernel K2 (csrc/pfb_wola.cu, the PFB) against its bound:
the least time for its function on each launch's shapes (bounds.k2_bound)
over K2's device time by kernel name in the profiled sub-window, %."""
from portbench import bounds

CALLS = {"k2": [("tetra_tpu_torch.phy.pfb", "pfb_channelize_rows")]}


def read(ctx):
    p = ctx.prof
    if not p:
        return None
    t = sum(s for name, (s, _) in p["kernels"].items() if "pfb_wola" in name)
    calls = p["args"].get("k2", [])
    if t <= 0 or not calls:
        return None
    need = 0.0
    for a, k in calls:
        re, n_chan, J = a[0], int(a[5]), int(a[6])
        T = max(int(re.shape[0]), n_chan * J)
        frames = (T - n_chan * J) // (n_chan // 2) + 1
        need += bounds.k2_bound(n_chan, T, frames, J)
    return 100.0 * need / t
