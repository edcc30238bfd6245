"""FEC operators: CRC16, scrambling, RCPC puncture maps, interleave maps,
Viterbi (kernels K1, K4, K6) and the TCH/S speech chain (acelp)."""
