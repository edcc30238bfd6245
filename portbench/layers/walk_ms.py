"""walk_ms: the host control plane a chunk (the bundle parse
FastChunkPipeline._decode_segments and the native walk
NativeControlPlane.walk2), synchronised spans, ms a chunk."""
SPANS = {"walk": [("tetra_tpu_torch.fastpath",
                   "FastChunkPipeline._decode_segments"),
                  ("tetra_tpu_torch.umac.native_exec",
                   "NativeControlPlane.walk2")]}


def read(ctx):
    return ctx.span_ms("walk")
