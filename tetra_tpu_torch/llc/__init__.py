"""LLC layer (copy of tetra_tpu.llc)."""
