"""FEC operators: CRC16, scrambling, puncture/interleave maps, Viterbi,
and the assembled-decode kernel K1."""
