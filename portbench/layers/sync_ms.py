"""sync_ms: the burst synchroniser a chunk (phy/sync_vec.sync_scan as
the fused chunk calls it: the next-match maps, then kernel S1), a
synchronised span, ms a chunk."""
SPANS = {"sync": [("tetra_tpu_torch.fastpath", "sync_scan")]}


def read(ctx):
    return ctx.span_ms("sync")
