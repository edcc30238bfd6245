"""MLE and layer-3 dispatch (copy of tetra_tpu.mle)."""
