"""frontend_ms.mixer: the mixer-bank front end a chunk
(rx_multi.MultiCarrierReceiver._mixer_bits: dequantize, oscillator,
127-tap FIR, resampler, hard demod), a synchronised span, ms a chunk."""
SPANS = {"frontend.mixer": [("tetra_tpu_torch.rx_multi",
                             "MultiCarrierReceiver._mixer_bits")]}


def read(ctx):
    return ctx.span_ms("frontend.mixer")
