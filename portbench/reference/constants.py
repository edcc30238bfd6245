"""Protocol constants from ETSI EN 300 392-2 / EN 300 395-2.

Frozen copy of the port's copy of tetra_tpu.constants (the benchmark's
reference: it imports nothing of the program). The port's copy is
held to the JAX package's original by the port's CPU tests.

Every table here is standardised protocol data (bit layouts, generator
polynomials, training sequences); sources are cited as reference
file:line for parity checking against osmocom/osmo-tetra.
"""
from __future__ import annotations

import numpy as np

# --- timeslot geometry (reference src/tetra_common.h:18-19) ---
SYM_PER_TS = 255
BITS_PER_TS = SYM_PER_TS * 2

# TDMA hierarchy (reference src/tetra_tdma.h:6-12)
TN_PER_FRAME = 4
FN_PER_MULTIFRAME = 18
MN_PER_HYPERFRAME = 60

# --- CRC (reference src/lower_mac/crc_simple.c:30, src/tetra_common.h:69) ---
CRC16_POLY = 0x1021
CRC16_INIT = 0xFFFF
TETRA_CRC_OK = 0x1D0F

# LLC FCS-32 (reference src/tetra_llc_pdu.c:107-126)
FCS32_POLY = 0x04C11DB7

# --- scrambler (reference src/lower_mac/tetra_scramb.c:34-50) ---
# Fibonacci LFSR taps, numbered as in the reference's ST(x,y) macro
SCRAMB_TAPS = (32, 26, 23, 22, 16, 12, 11, 10, 8, 7, 5, 4, 2, 1)
SCRAMB_INIT = 3  # BSCH predefined scrambling (tetra_scramb.h:14)

# --- RCPC mother code, rate 1/4 K=5 (reference src/lower_mac/tetra_conv_enc.c:43-74)
# Each generator is the set of delay taps XORed with the input bit.
# G1 = 1 + D + D4 ; G2 = 1 + D2 + D3 + D4 ; G3 = 1 + D + D2 + D4 ; G4 = 1 + D + D3 + D4
CONV_GENERATORS_CCH = ((1, 4), (2, 3, 4), (1, 2, 4), (1, 3, 4))
# Speech code, rate 1/3 (reference src/lower_mac/viterbi_tch.c:27-31):
# G1 = 1 + D + D2 + D3 + D4 ; G2 = 1 + D + D3 + D4 ; G3 = 1 + D2 + D4
CONV_GENERATORS_TCH = ((1, 2, 3, 4), (1, 3, 4), (2, 4))
CONV_K = 5  # constraint length

# --- puncturers (reference src/lower_mac/tetra_conv_enc.c:96-223) ---
# P tables per Section 8.2.3.1.3-6 / EN 300 395-2 5.5-5.6
PUNCT_P_2_3 = (0, 1, 2, 5)
PUNCT_P_1_3 = (0, 1, 2, 3, 5, 6, 7)
PUNCT_P_8_12 = (0, 1, 2, 4)
PUNCT_P_8_18 = (0, 1, 2, 3, 4, 5, 7, 8, 10, 11)
PUNCT_P_8_17 = (0, 1, 2, 3, 4, 5, 7, 8, 10, 11, 13, 14, 16, 17, 19, 20, 22, 23)

# scheme name -> (P, t, period, i_func)  where i_func maps j -> i
PUNCT_SCHEMES = {
    "2_3": (PUNCT_P_2_3, 3, 8, "eq"),
    "1_3": (PUNCT_P_1_3, 6, 8, "eq"),
    "292_432": (PUNCT_P_2_3, 3, 8, "292"),
    "148_432": (PUNCT_P_1_3, 6, 8, "148"),
    "112_168": (PUNCT_P_8_12, 3, 6, "eq"),
    "72_162": (PUNCT_P_8_18, 9, 12, "eq"),
    "38_80": (PUNCT_P_8_17, 17, 24, "eq"),
}

# --- RM(30,14) generator, Section 8.2.3.2 (reference src/lower_mac/tetra_rm3014.c:28-43)
RM3014_GEN = np.array([
    [1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0],
    [1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0],
    [0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1],
    [0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1],
    [0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 0, 1, 1, 0, 1],
    [0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1],
    [0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1],
    [0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1],
], dtype=np.uint8)

# --- training sequences, Section 9.4.4.3 (reference src/phy/tetra_burst.c:58-70)
TRAIN_N = np.array([1,1, 0,1, 0,0, 0,0, 1,1, 1,0, 1,0, 0,1, 1,1, 0,1, 0,0], dtype=np.uint8)
TRAIN_P = np.array([0,1, 1,1, 1,0, 1,0, 0,1, 0,0, 0,0, 1,1, 0,1, 1,1, 1,0], dtype=np.uint8)
TRAIN_Q = np.array([1,0, 1,1, 0,1, 1,1, 0,0, 0,0, 0,1, 1,0, 1,0, 1,1, 0,1], dtype=np.uint8)
TRAIN_X = np.array([1,0, 0,1, 1,1, 0,1, 0,0, 0,0, 1,1, 1,0, 1,0, 0,1, 1,1, 0,1, 0,0, 0,0, 1,1], dtype=np.uint8)
TRAIN_Y = np.array([1,1, 0,0, 0,0, 0,1, 1,0, 0,1, 1,1, 0,0, 1,1, 1,0, 1,0, 0,1, 1,1, 0,0, 0,0, 0,1, 1,0, 0,1, 1,1], dtype=np.uint8)
TRAIN_N_CAP = np.array([1,1,1, 0,0,1, 1,0,1, 1,1,1, 0,0,0, 1,1,1, 1,0,0, 0,1,1, 1,1,0, 0,0,0, 0,0,0], dtype=np.uint8)
TRAIN_P_CAP = np.array([1,0,1, 0,1,1, 1,1,1, 1,0,1, 0,1,0, 1,0,1, 1,1,0, 0,0,1, 1,0,0, 0,1,0, 0,1,0], dtype=np.uint8)
TRAIN_X_CAP = np.array([0,1,1,1,0,0,1,1,0,1,0,0,0,0,1,0,0,0,1,1,1,0,1,1,0,1,0,1,0,1,1,1,1,1,0,1,0,0,0,0,0,1,1,1,0], dtype=np.uint8)

# frequency-correction field f1..f80 (reference src/phy/tetra_burst.c:52-58)
FREQ_CORR = np.zeros(80, dtype=np.uint8)
FREQ_CORR[0:8] = 1
FREQ_CORR[72:80] = 1

# tail bits (reference src/phy/tetra_burst.c:73-74)
TAIL_BITS = np.array([1, 1, 0, 0], dtype=np.uint8)
TAIL_BITS_EXT = np.array([1, 1, 1, 0, 0, 0], dtype=np.uint8)

# train-seq ids (reference src/phy/tetra_burst.h:28-34)
TETRA_TRAIN_NORM_1 = 0
TETRA_TRAIN_NORM_2 = 1
TETRA_TRAIN_NORM_3 = 2
TETRA_TRAIN_SYNC = 3
TETRA_TRAIN_EXT = 4

# burst field offsets in bits (reference src/phy/tetra_burst.c:30-46)
SB_BLK1_OFFSET = (6 + 1 + 40) * 2
SB_BBK_OFFSET = (6 + 1 + 40 + 60 + 19) * 2
SB_BLK2_OFFSET = (6 + 1 + 40 + 60 + 19 + 15) * 2
SB_BLK1_BITS = 60 * 2
SB_BBK_BITS = 15 * 2
SB_BLK2_BITS = 108 * 2

NDB_BLK1_OFFSET = (5 + 1 + 1) * 2
NDB_BBK1_OFFSET = (5 + 1 + 1 + 108) * 2
NDB_BBK2_OFFSET = (5 + 1 + 1 + 108 + 7 + 11) * 2
NDB_BLK2_OFFSET = (5 + 1 + 1 + 108 + 7 + 11 + 8) * 2
NDB_BBK1_BITS = 7 * 2
NDB_BBK2_BITS = 8 * 2
NDB_BLK_BITS = 108 * 2

# where each training sequence sits inside an aligned 510-bit slot
# (reference src/phy/tetra_burst_sync.c:123,133)
SYNC_TRAIN_OFFSET = 214
NORM_TRAIN_OFFSET = 244

# Phase adjustment ranges, Table 8.14 (reference src/phy/tetra_burst.c:80-95)
PHASE_ADJ_N = {
    "HA": (8, 122), "HB": (123, 249), "HC": (8, 108), "HD": (109, 249),
    "HE": (112, 230), "HF": (1, 111), "HG": (3, 117), "HH": (118, 224),
    "HI": (3, 103), "HJ": (104, 224),
}

# symbol<->bits maps (reference src/phy/tetra_burst.c:97-115).
# NB: in bits2phase the symbol index is bits[2n] | bits[2n+1]<<1 (first
# bit = LSB), and the two tables are intentionally NOT inverses of each
# other — replicated exactly as the reference uses them.
BITS2PHASE = {(0, 0): 1, (1, 0): -1, (0, 1): 3, (1, 1): -3}
PHASE2BITS = {-3: (1, 1), -1: (0, 1), 1: (0, 0), 3: (1, 0)}

# --- lower MAC block parameters (reference src/lower_mac/tetra_lower_mac.c:55-102)
# name -> (type345_bits, type2_bits, type1_bits, interleave_a, have_crc16)
BLOCK_PARAMS = {
    "SB1": (120, 80, 60, 11, True),
    "SB2": (216, 144, 124, 101, True),
    "NDB": (216, 144, 124, 101, True),
    "SCH_HU": (168, 112, 92, 13, True),
    "SCH_F": (432, 288, 268, 103, True),
    "BBK": (30, 30, 14, 0, False),
}

# --- ACELP speech bit classes, EN 300 395-2 Table 4
# (reference src/lower_mac/tch_reordering.c:30-92)
ACELP_CLASS0 = np.array([
    35, 36, 37, 38, 39, 40, 41, 42, 33, 47, 48, 56, 61, 62, 63, 65, 66, 67,
    68, 69, 70, 74, 75, 83, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 101, 102,
    110, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 128, 129, 137,
], dtype=np.int32)
# NB: reference table has 51 entries; entry between 48 and 56 is 56? Keep
# exact copy of standardized positions:
ACELP_CLASS0 = np.array([
    35, 36, 37, 38, 39, 40, 41, 42, 33, 47, 48, 56, 61, 62, 63, 65, 66, 67,
    68, 69, 70, 74, 75, 83, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 101, 102,
    110, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 128, 129, 137,
], dtype=np.int32)
ACELP_CLASS1 = np.array([
    58, 85, 112, 54, 81, 108, 135, 50, 77, 104, 131, 45, 72, 99, 126, 55, 82,
    109, 136, 5, 13, 34, 8, 16, 17, 22, 23, 24, 25, 26, 6, 14, 7, 15, 60, 87,
    114, 46, 73, 100, 127, 44, 71, 98, 125, 33, 49, 76, 103, 130, 59, 86,
    113, 57, 84, 111,
], dtype=np.int32)
ACELP_CLASS2 = np.array([
    18, 19, 20, 21, 31, 32, 53, 80, 107, 134, 1, 2, 3, 4, 9, 10, 11, 12, 27,
    28, 29, 30, 52, 79, 106, 133, 51, 78, 105, 132,
], dtype=np.int32)

# --- carrier frequency math (reference src/tetra_common.c:41-91) ---
CARRIER_SPACING_HZ = 25_000
CARRIER_OFFSET_HZ = (0, 6250, -6250, 12500)
DUPLEX_SPACING_KHZ = (
    (-1, 1600, 10000, 10000, 10000, 10000, 10000, -1, -1, -1, -1, -1, -1, -1, -1, -1),
    (-1, 4500, -1, 36000, 7000, -1, -1, -1, 45000, 45000, -1, -1, -1, -1, -1, -1),
    (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (-1, -1, -1, 8000, 8000, -1, -1, -1, 18000, 18000, -1, -1, -1, -1, -1, -1),
    (-1, -1, -1, 18000, 5000, -1, 30000, 30000, -1, 39000, -1, -1, -1, -1, -1, -1),
    (-1, -1, -1, -1, 9500, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1),
    (-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1),
    (-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1),
)


def dl_carrier_hz(band: int, carrier: int, offset: int) -> int:
    """Downlink carrier frequency (reference src/tetra_common.c:62-68)."""
    return band * 100_000_000 + carrier * CARRIER_SPACING_HZ + CARRIER_OFFSET_HZ[offset & 3]


def ul_carrier_hz(band: int, carrier: int, offset: int, duplex: int, reverse: int) -> int:
    """Uplink carrier frequency (reference src/tetra_common.c:80-91).

    Bit-faithful to the reference INCLUDING its signedness bug: it
    assigns the int16 spacing to a uint32, so the `< 0` reserved-value
    check never fires and a reserved (-1) spacing wraps to
    0xFFFFFFFF * 1000 mod 2^32 = -1000, yielding UL = DL +/- 1000 Hz
    instead of the intended 0 (pinned by the compiled oracle in
    tests/test_ref_parity_upper.py::test_sysinfo_carrier_hz)."""
    freq = dl_carrier_hz(band, carrier, offset)
    spacing = DUPLEX_SPACING_KHZ[duplex & 7][band & 15] & 0xFFFFFFFF
    spacing = (spacing * 1000) & 0xFFFFFFFF
    if reverse:
        return (freq + spacing) & 0xFFFFFFFF
    return (freq - spacing) & 0xFFFFFFFF
