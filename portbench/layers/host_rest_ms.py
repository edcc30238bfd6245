"""host_rest_ms: the receiver and the chunk pipeline's own time a chunk
(rx_multi, fastpath: receiver construction, streaming, the chunk
program's other launches and copies, Python): the traced passes' time
less the front-end, sync, FEC and walk spans, ms a chunk."""
SPANS = {
    "frontend.pfb": [("tetra_tpu_torch.fastpath", "_iq_frontend")],
    "frontend.mixer": [("tetra_tpu_torch.rx_multi",
                        "MultiCarrierReceiver._mixer_bits")],
    "sync": [("tetra_tpu_torch.fastpath", "sync_scan")],
    "fec": [("tetra_tpu_torch.lmac.fused", "decode_slots_fused"),
            ("tetra_tpu_torch.lmac.pipeline", "decode_block")],
    "walk": [("tetra_tpu_torch.fastpath",
              "FastChunkPipeline._decode_segments"),
             ("tetra_tpu_torch.umac.native_exec", "NativeControlPlane.walk2")],
}


def read(ctx):
    if not ctx.chunks:
        return None
    rest = ctx.pass_s - sum(ctx.spans.get(n, 0.0) for n in SPANS)
    return rest / ctx.chunks * 1e3
