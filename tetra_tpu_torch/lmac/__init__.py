"""Lower MAC: SB1 decode and the kind-compacted fused slot decode."""
