"""frontend_ms.pfb: the PFB front end a chunk (fastpath._iq_frontend:
dequantize, K2, K3, hard demod), a synchronised span, ms a chunk."""
SPANS = {"frontend.pfb": [("tetra_tpu_torch.fastpath", "_iq_frontend")]}


def read(ctx):
    return ctx.span_ms("frontend.pfb")
