"""fec_ms: the lower-MAC decode a chunk (lmac/fused.decode_slots_fused,
K1 at 288 steps, and the SB1 pre-decode lmac/pipeline.decode_block, K1
at 80), synchronised spans, ms a chunk."""
SPANS = {"fec": [("tetra_tpu_torch.lmac.fused", "decode_slots_fused"),
                 ("tetra_tpu_torch.lmac.pipeline", "decode_block")]}


def read(ctx):
    return ctx.span_ms("fec")
