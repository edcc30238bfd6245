#!/usr/bin/env python3
"""GPU bring-up check of the PyTorch/CUDA port (tetra_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (one JSON line each):
  1. device   nvidia-smi name and power limit; nvcc build of csrc/*.cu.
  2. kernels  each hand-written kernel against its plain PyTorch
              version on the card, at the main path's shapes and at the
              CPU-test shapes: K1 (assembled Viterbi + CRC, n_sym 288,
              80 and 144) bit-identical, K2 (PFB WOLA; C 1024, 512 at
              wide-512's n_slots-168 length, 8, 12 and 1000) and K3
              (resampler, on K2's rows: time-major, channel-major, and
              channel-major over a permuted half of the channels as
              int64 and int32) within max|d| <= 1e-4 * max|plain|, with
              torch.fft.fft over K2's [M, C] frames timed beside K2 (the
              DFT stage alone, for reference), K3's conv2d yardstick
              (k3_library, held to the same tolerance first) and the
              gather and transposes the front end ran before K3 wrote
              channel-major (layout_copy_ms) timed beside K3, K4 (f32 segmented
              Viterbi, n_sym 288 at ~21.5k rows, 80, 77 with two
              restarts and 292) bit-identical; times of both. K1 and K4
              also on the edge cases of their lane-group layout (row
              counts 1, 3, 17, 3001; all-erasure rows; rows tied at a
              restart boundary; every subset of the restarts; K1's tab
              mixing every map), bit-identical.
  3. small    an 8-carrier production capture through the receiver on
              the card and on the CPU (plain versions): identical
              per-carrier stats and native event arrays.
     voice_small  the same capture with traffic dumps, voice decode,
              GSMTAP (to a local UDP sink on an ephemeral port) and a
              TL-SDU sink, on the card and on the CPU: every file,
              packet and sink call identical.
     rx_small  tetra_tpu_torch.rx.TetraReceiver (keystore, dumps,
              voice) on one carrier of that capture on the card and on
              the CPU, in 3 chunks and in one call: identical log
              lines, stats, TMV records and files, equal to the JAX
              receiver's record in the fixture; K1 and K6 launched.
     cli      python3 -m tetra_tpu_torch.rx -f bits, and -f iq on a
              cfile modulated from the same bits, in subprocesses on the
              card and with --device cpu: identical stdout and dumps;
              and python3 -m tetra_tpu_torch.receiver --file (that
              cfile), --udp (the bits over loopback) and --audio (96 kHz
              s16le PCM, carrier at +5 kHz, --calibration 5000), the
              same way: identical stdout, stderr summary and dumps.
     python_small  the 8-carrier capture through
              control_plane="python" (process_iq4c and process_iq8) on
              the card and on the CPU: identical per-carrier log lines,
              stats and TL-SDU sink calls.
     mixer_small  the JAX mixer test's two-cell capture at 144 kHz with
              off-grid carriers (-31,400, +13,700 Hz) through the
              mixer bank on both planes: card = CPU (stats, log lines,
              native events), the card's run cut at 4,097, 11,003 and
              23,456 = its whole run, stats, cells and SSIs = the JAX
              record (prod_fixture.mixer_record).
     mixer    mixer-64, the live CLI end to end at full width: a mock
              rtl_tcp server process (tools/rtl_tcp_mock.py) serves 64
              off-grid carriers at 1.8 MS/s (1.0346 s, 6 TEA1) and
              tetra_tpu_torch.receiver.main --rtltcp --carriers <64
              offsets> -k runs warm and timed on each plane: every
              carrier = the JAX mixer record, 4 log digests equal,
              Python plane = native plane, K1 launched on both;
              wall_s, realtime_carriers and the front end's device
              split (mix, FIR, resample, demod; CUDA events on one
              chunk) with its share of the pass.
     scan     scan.scan(confirm=True) on the JAX scan test's 400 kHz
              two-cell u8 capture on the card and the CPU, and the CLI's
              --carriers auto on both planes and devices (the on-grid
              carriers through the PFB: K1, K2, K3 launched): equal to
              the JAX record; detect_carriers on mixer-64: the JAX
              record's candidates, SNRs and channel powers to 0.1 dB.
  4. prod     the 1024-carrier production capture (25 kHz spacing,
              fs 25.6 MS/s, 4 chunks, 102 TEA1-encrypted carriers)
              once warm and once timed; zero CRC errors, decode counts
              inside the window the JAX package recorded, the stats of
              carriers 304, 610, 291, 337, 419, 518, 628 and 989 equal to
              the JAX wideband path's record on the same capture
              (prod_fixture.wideband_record), and K1, K2 and K3 launched
              by the timed run.
     voice    the same capture once more, timed, with dumpdir (a
              temporary directory) and decode_voice: wall time beside
              prod's, traffic slots dumped, voice frames decoded, K6
              launched; every carrier whose stats equal the JAX bits
              path's must hold the fixture's files for its row (plain
              or encrypted), up to the raw traffic bits the wideband
              demod gets wrong (<= 1e-5 of them; a voice frame may
              differ only in such a slot, and there it must equal the
              CPU plain chain's decode of the card's own bits); the 8
              recorded carriers' files equal to the JAX wideband path's.
              K6's row count at each of its launches is counted from
              the events (one chunk's full frames or NDB halves).
     python_plane  the same capture through control_plane="python",
              timed: per-carrier stats equal to the native plane's, the
              8 recorded carriers' stats and log digests equal to the
              JAX Python plane's (prod_fixture.python_record), the host
              split (front end, MultiSync.scan, decode_slots_multi,
              per-carrier walk) and K1, K2 and K3 launched.
     kernels  K6 (unsegmented Viterbi, 8 rows per block of K4's body)
              bit-identical to its plain version at the voice pass's
              own per-launch row counts (n_sym 112 and 72, speech code,
              the voice alphabet) and on its edge cases (all-erasure
              rows, rows zeroed before step n_sym // 2, multiples of
              0.25) at row counts 1, 3, 17, 1000, 2000, 3001, 3072 and
              n_sym 112, 72, 77, 113, 71, 292; times of both, and of an
              empty kernel launch (K6's bound is below it).
  5. soft_small  the 8-carrier snr8 capture through the soft receiver
              (demod="soft") on the card and on the CPU: identical
              stats and events.
  6. snr8     the 1024-carrier clean SYNC/SCH_F capture with AWGN at
              8 dB per-channel SNR through the soft receiver (4 chunks),
              once warm and once timed; crc_ok >= 0.90 x 81,920, crc_err
              <= 2 x the JAX record, the stats of the 16 carriers the
              fixture records equal to the JAX soft path's on the same
              capture (prod_fixture.soft_record), and K1..K4 launched by
              the timed run; the 5 carriers with the fewest CRC-OK
              blocks and the 5 with the most CRC errors are listed.
     kernels  S1 (the burst synchroniser's step loop, csrc/sync_scan.cu)
              against sync_scan_plain on the card: the sync_scan calls
              of the prod and snr8 warm passes (recorded: the ring plus
              each chunk, tol 0 and 2), mixer-64's MultiSync.scan calls
              of its warm Python-plane pass replayed through S1 and
              through the plain version, and sync_case's edge inputs
              (B 1, 3 and 4097, tol 0 and 2): every OUT_KEYS plane and
              the carry equal bit for bit; times of the whole call, the
              next-match maps, S1 alone and the plain version on prod's
              and snr8's last chunk. S1 must be launched by the prod,
              snr8, python_plane, mixer (both planes) and mesh passes.
  7. kernels  K5 (fused hard demod: bits of the picked phase, the pick,
              the metric sums) against its plain version at the steady
              chain's shape [4096, 32,768] (half the carriers with AWGN
              at 8 dB), at the CPU tests' ragged [7, 602] and at the
              other CPU-test shapes (K5_SMALL): decisions identical on
              clean carriers, <= 1e-3 differing on noisy ones, the same
              timing phase on every carrier, metric sums within 1e-4
              relative, and the smallest phase margin; times of both. K1 at the steady chain's shape: every K1
              call locked_step_ri(fast="pallas") makes on that noisy
              capture under both decoder sets (n288, n80, n144; 262,144
              rows each) bit-identical to its plain version. The K7
              stage bisect (tools/profile_torch_demod.py), its bits
              identical to the plain version's.
  8. steady_small  8 carriers x 64 slots of the steady fixture (4 with
              AWGN at 8 dB) through locked_step_ri on the card and on the
              CPU, fast="pallas" under both decoder sets and fast="soft":
              every output identical.
  9. steady   4096 carriers x 64 slots (bench stage 3's shape), clean,
              through locked_step_ri(fast="pallas") with
              decoders=("fused",) and the default three, once warm and
              once timed each: every kind, crc_ok and payload as the
              fixture says, K5 and K1 launched by the timed pass.
 10. kernels  K5 at every rate it is built for (sps 1..11) against its
              plain version on 64 clean carriers x 8,192 symbols and on a
              ragged [7, 5,003]: bits and phase picks identical, metric
              sums within 1e-5 relative; the kernel's and the plain
              version's times and the bound at each rate.
     k5_sps   locked_step_ri(fast="pallas", sps=1, 4, 8) on 512 carriers
              of the steady fixture modulated at that rate: every output
              of the first 64 carriers equal to the CPU plain chain's,
              later carriers equal to their roll's, every slot equal to
              the fixture at sps 4 and 8 (sps 1 aliases: its fixture
              mismatches are printed), K5 (timed at that shape) and K1
              launched.
     tx       the steady fixture rebuilt by the port's tx on the card;
              python3 -m tetra_tpu_torch.selftest in subprocesses on the
              card and with --device cpu (identical stdout, exit 0, 0 CRC
              errors); 262,144 SCH/F blocks + AACH encoded on the card
              and decoded by decode_schf_burst (K1): all CRC-OK and
              exact, card = CPU on the first 1,024.
     eq_small the 8-carrier degraded capture (steady_fixture.eq_capture)
              through locked_step_ri(fast="eq") on the card and on the
              CPU (eq_differs: identical on every slot either
              classifies, <= 1e-3 of the NDB slots' bits differing).
     eq       steady-eq-4096 (run_eq): the recorded carriers equal the
              JAX record and the CPU, each channel group's CRC-OK share
              beside the record's, every CRC-OK slot equal to the
              fixture; wall_s of fast="eq" and "pallas" on the same
              planes, the eq layer split, fast=False on the clean
              capture.
     wide512  bench stage 5 (run_wide512): the 512-channel PFB (K2, K3)
              feeding locked_step_ri(fast="pallas") (K5, K1) on noise at
              the bench's shapes (card = CPU, samples per second) and on
              the fixture's carriers on 8 channels (every slot decoded);
              pfb_channelize_ri against K2's rows.
 11. mesh     MESH_RANKS (4) ranks on cuda:0, each its own process and
              CUDA context, joined by gloo (tetra_tpu_torch.parallel):
              prod-1024's bits through MultiCarrierReceiver(native,
              mesh=<4-rank carrier mesh>), 256 carriers a rank: every
              carrier's (bursts, crc_ok, crc_wrong) equal to the JAX bits
              path's record and to the one-process native pass on the
              same bits, its TL-SDUs equal carrier by carrier, each
              rank's sink holding only its own carriers, the event totals
              the record's; the soft fused chunk on the dry run's capture
              (K4 on every rank) equal to the one-process run;
              sharded_locked_step on steady-4096 (1024 carriers a rank)
              and sharded_locked_step_2d on its slots cut at bit 0 (2
              hosts x 2 chips, each host rank holding its own 32 slots)
              equal to the one-process chain, 262,144 CRC-OK; the
              time-sharded PFB (512 channels, 8.4 M samples) within
              1e-4 of the peak of the one-process channelizer, both
              timed; the dry run (tetra_tpu_torch.parallel.dryrun); then
              bench stage 6's iq8 and iq4 ingest over stream_map, the
              CRC counts equal to a plain loop's, samples per second.
              wall_s of each check (the slowest rank's) and its kernel
              launches summed over the ranks.
Then the kernel summary line (each kernel's launches on its main path,
max_abs_err, ms, plain_ms, the bound computed from the run's shapes
and what sets it, and library_ms: for K3 one conv2d call over the
stacked planes, for the others null, no single PyTorch call computes
their functions; for K1, K2 and K3 also their launches
on the Python plane's pass, for K3 on snr8's, for K1 also on the mixer pass's two planes
and on the eq, wide512 and tx passes, on the mesh phase's prod-1024
bits and steady chains and on stream_map, for K4 on the mesh phase's
soft fused chunk, for K5 on stream_map, for K2, K3 and K5 on wide512,
one entry per K5 rate,
for S1 (sync_scan) its launches per call and on the snr8, Python-plane,
mixer and mesh passes, the maps' and S1's own times, and library_ms
null with the reason (no PyTorch call computes this state machine),
for K3 its share of the bound, its time-major and subset times, the
layout copies and wide-512's time; for K1, K2,
K3, K4, K5, K6 and S1 also resident blocks
per SM, registers per thread and shared bytes per block at the main
path's shape, for K2 dft_only_ms and for K6 empty_launch_ms), the
nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits nonzero without that line when
there is no card, the build fails, or any check fails.
"""
import contextlib
import functools
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback
from unittest import mock

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tools"))

TOL = 1e-4          # K2/K3: max |kernel - plain| <= TOL * max |plain|
N_CAR = 1024
N_CHUNKS = 4
K4_ROWS = 21_504    # rows per chunk of the snr8 path's soft FEC
K6_ROWS = 3_072     # ~traffic slots per chunk of the prod-1024 voice pass
CLEAN_CRC_OK = 81_920
STEADY_CAR = 4096   # bench stage 3: 4096 carriers x 64 slots
RAGGED = (1, 3, 17, 3001)   # K1/K4 row counts that fill no warp or block
ALL3 = ("sync", "schf", "ndb")
HBM_BPS = 3.35e12   # H100 SXM device memory rate (bytes/s)
# H100 SXM peaks outside the tensor cores (data sheet: 67 TFLOP/s f32,
# an FMA counted as 2): multiply-adds at F32_FLOPS; f32 adds, compares
# and selects at one per lane and clock; int32 on 64 lanes per SM, half
# the f32 lanes
F32_FLOPS = 67e12
F32_OPS = F32_FLOPS / 2
INT32_OPS = F32_FLOPS / 4
# raw type-4 bits of the voice pass that may differ from the JAX bits
# path's: the wideband demod's bit errors on this clean capture (1.1e-6
# measured on an H100 80GB HBM3 at 700 W); traffic bits carry no CRC
RAW_BIT_LIMIT = 1e-5


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also gets t_s, the seconds since
    the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (inputs read once, outputs written once) over
    the memory rate and its operations over `peak`, the rate of their
    type (none of these kernels uses the tensor cores)."""
    tb, to = nbytes / HBM_BPS, ops / peak
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes": nbytes, "bound_ops": ops, "bound_peak": peak}


def viterbi_ops(rows: int, n_sym: int, n_gen: int) -> int:
    """Operations of a radix-2 16-state decode: per row and step the
    2^n_gen distinct branch metrics (n_gen - 1 adds each), 16
    add-compare-selects (4 each) and a traceback step."""
    return rows * n_sym * (2 ** n_gen * (n_gen - 1) + 64 + 1)


def k2_bound(n_chan: int, T: int, frames: int, J: int = 16) -> dict:
    """K2: planes in, the prototype and twiddles once, [M, C] complex
    out; per frame and channel a complex window-and-fold over J branches
    (4 ops each) and its share of a C-point complex FFT (5 log2 C)."""
    return bound(8 * T + 4 * (J * n_chan + 2 * n_chan) + 8 * frames * n_chan,
                 frames * n_chan * (4 * J + 5 * math.log2(n_chan)),
                 F32_FLOPS)


def k5_bound(n: int, sps: int = 2) -> dict:
    """K5 on n samples at sps samples a symbol: planes in (8 B a sample),
    bits out (2 B a symbol); per sample a complex matched filter (4 ops a
    tap of rrc_taps(sps), 11·sps taps), the differential phasor and the
    metric."""
    return bound(8 * n + 2 * (n // sps), n * (4 * 11 * sps + 16), F32_FLOPS)


def rel_err(got, want) -> tuple[float, float]:
    d = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return d, scale


def reset_launches():
    from tetra_tpu_torch import kernels
    kernels.reset_launches()


def launches() -> dict:
    from tetra_tpu_torch import kernels
    return kernels.launches()


def slot_batch(n_rows: int, dev, seed: int = 1):
    """~n_rows real slots cut from the fixture rows at the positions the
    port's synchroniser emits, tiled and corrupted with 0..60 random
    bit flips each; returns (slots [n, 510] int8, kinds [n]) on dev."""
    import numpy as np
    import torch
    from tetra_tpu_torch import prod_fixture
    from tetra_tpu_torch.phy.sync_vec import sync_scan
    fx = prod_fixture.load()
    rows = np.stack([fx["plain"], fx["enc"]]).astype(np.int8)
    bits = torch.as_tensor(rows)
    z = torch.zeros(2, dtype=torch.int32)
    steps = rows.shape[1] // 64
    _, out = sync_scan(bits, z, z, z, z, z, 0, steps)
    t, c = torch.nonzero(out["emit"], as_tuple=True)
    kinds = out["col"][t, c].to(torch.int64)
    slots = torch.stack([bits[ci, s:s + 510] for ci, s in
                         zip(c.tolist(), out["slot"][t, c].tolist())])
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(slots), n_rows)
    sl = slots[pick].numpy().copy()
    kd = kinds[pick].numpy()
    nflip = rng.integers(0, 61, n_rows)
    for i in range(n_rows):
        if nflip[i]:
            sl[i, rng.choice(510, nflip[i], replace=False)] ^= 1
    return (torch.as_tensor(sl, device=dev),
            torch.as_tensor(kd, device=dev))



# S1's function (a sync_scan call) at its least, for its bound: each
# locked column's match at every position as a bit-sliced packed compare
# (32 positions a word; per sequence bit a funnel shift and one logic op
# folding it into the match word at tol 0, a second logic op for the
# two-bit saturating error count at tol 1..2), and per carrier and step
# the ring clamp and append 6, the KNOW_FSTART hand-over 7, per column
# the next set bit of its match word from the window start 4, the
# polluted-prefix visibility 5 and the fit 2 (33 for three), the
# acquisition 8, the key and column 12, the offsets and the bad, lost
# and emit flags 16, the tolerant override 6 and the carry's advance 8
SYNC_SEQ_BIT_OPS = {0: 2, 1: 3, 2: 3}
SYNC_STEP_OPS = 6 + 7 + 3 * (4 + 5 + 2) + 8 + 12 + 16 + 6 + 8
SYNC_CARRY = ("state", "buf_start", "nbuf", "nfs", "slot_index")


def sync_case(B: int, steps: int, seed: int, dev, n_kf: int = 7):
    """Inputs of one sync_scan call at B carriers and `steps` feed quanta:
    bits [B, 4096 + 64 * steps] int8 cut from the production rows
    (prod_fixture's plain and encrypted rows, alternating), each carrier
    at its own offset, with 2e-3 random bit flips and a 600-bit garbage
    span at a random place; the carry zero except every n_kf-th carrier
    in KNOW_FSTART with its frame start before its buffer start (every
    2·n_kf-th at -1). Returns (bits, carry tuple of five int32 [B]) on
    dev."""
    import numpy as np
    import torch
    from tetra_tpu_torch import prod_fixture
    fx = prod_fixture.load()
    rows = np.stack([fx["plain"], fx["enc"]]).astype(np.int8)
    L = 4096 + 64 * steps
    rng = np.random.default_rng(seed)
    start = rng.integers(0, rows.shape[1] - L, B)
    pos = start[:, None] + np.arange(L)
    bits = rows[(np.arange(B) % 2)[:, None], pos]
    bits ^= (rng.random((B, L), dtype=np.float32) < 2e-3).astype(np.int8)
    g0 = rng.integers(0, L - 600, B)
    bits[np.arange(B)[:, None], g0[:, None] + np.arange(600)] = \
        rng.integers(0, 2, (B, 600), dtype=np.int8)
    carry = np.zeros((5, B), np.int32)
    kf = np.arange(B) % n_kf == n_kf - 1
    carry[0, kf] = 1
    carry[1, kf] = 700
    carry[2, kf] = 1500
    carry[3, kf] = 300
    carry[3, np.arange(B) % (2 * n_kf) == 2 * n_kf - 1] = -1
    return (torch.as_tensor(bits, device=dev),
            tuple(torch.as_tensor(c, device=dev) for c in carry))


def sync_args(args, kwargs) -> dict:
    """A sync_scan call's arguments by name, defaults filled in."""
    import inspect
    from tetra_tpu_torch.phy import sync_vec as sv
    b = inspect.signature(sv.sync_scan_plain).bind(*args, **kwargs)
    b.apply_defaults()
    return dict(b.arguments)


def sync_compare(args, kwargs) -> dict:
    """sync_scan (S1 on a card) against sync_scan_plain on the same
    inputs: the OUT_KEYS planes (values and type), the carry and fed
    that differ, and the largest absolute difference of any of them."""
    import torch
    from tetra_tpu_torch.phy import sync_vec as sv
    (*kc, kfed), ko = sv.sync_scan(*args, **kwargs)
    (*pc, pfed), po = sv.sync_scan_plain(*args, **kwargs)
    pairs = [(k, ko[k], po[k]) for k in sv.OUT_KEYS] \
        + list(zip(SYNC_CARRY, kc, pc))
    differ = [k for k, a, b in pairs
              if a.dtype != b.dtype or a.shape != b.shape
              or not torch.equal(a, b)]
    err = max((float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for _, a, b in pairs if a.numel() and a.shape == b.shape),
              default=0.0)
    if kfed != pfed:
        differ.append("fed")
    a = sync_args(args, kwargs)
    return {"carriers": int(a["bits"].shape[0]),
            "window_bits": int(a["bits"].shape[1]), "steps": a["steps"],
            "tol": a["tol"], "differ": differ, "max_abs_err": err,
            "emitted": int(ko["emit"].sum())}


def sync_bound(B: int, L: int, steps: int, tol: int) -> dict:
    """S1's function (a sync_scan call) at B carriers, window L, `steps`
    steps and tolerance tol: bits read once (1 B each), the carry read
    and written (40 B a carrier), the ten planes written once (25 B a
    carrier and step); int32 operations (SYNC_SEQ_BIT_OPS and
    SYNC_STEP_OPS above: no f32 work is needed) at INT32_OPS."""
    from tetra_tpu_torch.phy.burst import LOCKED_COLS
    from tetra_tpu_torch.phy.sync import _SEQ_LEN
    match_ops = SYNC_SEQ_BIT_OPS[tol] * sum(_SEQ_LEN[c] for c in LOCKED_COLS) \
        * B * L / 32
    return {**bound(B * L + 40 * B + 25 * B * steps,
                    match_ops + SYNC_STEP_OPS * B * steps, INT32_OPS),
            "bound_match_ops": match_ops}


def sync_times(args, kwargs) -> dict:
    """CUDA-event times of one sync_scan call (mean of 10 after a warm-up;
    the plain version's of 2): the whole call on the card (next-match
    maps + S1), the maps alone, S1 alone, sync_scan_plain; S1's launches
    in one call; the bound."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch.phy import sync_vec as sv
    a = sync_args(args, kwargs)
    bits, steps, feed, tol = a["bits"], a["steps"], a["feed"], a["tol"]
    carry = torch.stack([a[k].to(torch.int32) for k in
                         ("state0", "buf_start0", "nbuf0", "nfs0", "slot0")])
    nm = sv.next_match_maps(bits, tol)
    before = sv.sync_scan.launches
    sv.sync_scan(*args, **kwargs)
    per_call = sv.sync_scan.launches - before
    B, L = bits.shape
    return {"carriers": B, "window_bits": L, "steps": steps, "tol": tol,
            "launches_per_call": per_call,
            "ms": cuda_ms(lambda: sv.sync_scan(*args, **kwargs)),
            "maps_ms": cuda_ms(lambda: sv.next_match_maps(bits, tol)),
            "steps_kernel_ms": cuda_ms(lambda: sv.sync_steps(
                bits, nm, carry, steps, feed, tol)),
            "plain_ms": cuda_ms(lambda: sv.sync_scan_plain(*args, **kwargs),
                                2),
            **sync_bound(B, L, steps, tol)}


@contextlib.contextmanager
def recording(owner, attr: str, calls: list):
    """Replace owner.attr by a wrapper that records every call's
    (args, kwargs), tensors cloned and numpy arrays copied, into `calls`
    and passes it through; restore it on exit."""
    import numpy as np
    import torch
    fn = getattr(owner, attr)
    snap = lambda v: (v.clone() if isinstance(v, torch.Tensor) else
                      v.copy() if isinstance(v, np.ndarray) else v)

    @functools.wraps(fn)
    def rec(*args, **kwargs):
        calls.append((tuple(map(snap, args)),
                      {k: snap(v) for k, v in kwargs.items()}))
        return fn(*args, **kwargs)
    setattr(owner, attr, rec)
    try:
        yield calls
    finally:
        setattr(owner, attr, fn)


def multisync_replay(dev, calls: list) -> dict:
    """The MultiSync.scan calls of a Python-plane pass (recorded with the
    instance as first argument) replayed into two fresh MultiSyncs on the
    card per instance, one through S1 and one with sync_scan_plain in
    its place: every call's slots and events, and the final carries,
    must be equal."""
    import numpy as np
    from tetra_tpu_torch.phy import sync_vec as sv
    by_inst: dict = {}
    for (inst, *rest), kw in calls:
        by_inst.setdefault(id(inst), (inst, []))[1].append((rest, kw))
    n_calls = n_slots = n_events = 0
    differ = []
    for inst, seq in by_inst.values():
        mk = sv.MultiSync(inst.n, inst.feed, device=dev)
        mp = sv.MultiSync(inst.n, inst.feed, device=dev)
        for i, (rest, kw) in enumerate(seq):
            got = mk.scan(*rest, **kw)
            with mock.patch.object(sv, "sync_scan", sv.sync_scan_plain):
                want = mp.scan(*rest, **kw)
            n_calls += 1
            n_slots += sum(map(len, got[0]))
            n_events += sum(map(len, got[1]))
            if got != want:
                differ.append(i)
        if any(not np.array_equal(getattr(mk.carry, f), getattr(mp.carry, f))
               for f in ("state", "buf_start", "bits_in_buf", "nfs",
                         "slot_index")) or mk.carry.fed != mp.carry.fed:
            differ.append("carry")
    return {"instances": len(by_inst), "calls": n_calls, "slots": n_slots,
            "events": n_events, "calls_differing": differ}



def check_sync(dev, prod_calls: list, snr8_calls: list,
               mixer_calls: list) -> dict:
    """S1 (csrc/sync_scan.cu) against sync_scan_plain on the card, on the
    sync_scan calls of a prod-1024 pass (4 chunks: the ring plus each
    chunk, hard, tol 0) and of an snr8-1024 pass (its soft window as
    soft < 0, tol 2), every OUT_KEYS plane and the carry equal bit for
    bit; mixer-64's MultiSync.scan calls of a Python-plane pass
    replayed through S1 and through the plain version, the same slots,
    events and carries; the synthetic edge inputs of sync_case at B 1,
    3 and 4097 with tol 0 and 2. Times of the last chunk's call (the
    largest window with a running carry) at both passes."""
    res = {"library_ms": None,
           "library_reason": "no PyTorch call computes this state machine"}
    bad = []
    for name, calls in (("prod", prod_calls), ("snr8", snr8_calls)):
        if not calls:
            raise AssertionError(f"S1: no sync_scan call of {name} recorded")
        per = [sync_compare(a, k) for a, k in calls]
        res[name] = {"calls": per, **sync_times(*calls[-1])}
        bad += [f"{name}[{i}]: {p['differ']}" for i, p in enumerate(per)
                if p["differ"]]
    res["mixer"] = multisync_replay(dev, mixer_calls)
    if res["mixer"]["calls_differing"] or not res["mixer"]["calls"]:
        bad.append(f"mixer: {res['mixer']}")
    edge = []
    for B, steps, seed in ((1, 146, 11), (3, 37, 12), (4097, 146, 13)):
        bits, carry = sync_case(B, steps, seed, dev)
        for tol in (0, 2):
            edge.append(sync_compare((bits, *carry, 0, steps),
                                     {"tol": tol}))
    res["edge"] = edge
    bad += [f"edge {e['carriers']} tol {e['tol']}: {e['differ']}"
            for e in edge if e["differ"]]
    res["max_abs_err"] = max(p["max_abs_err"] for p in
                             res["prod"]["calls"] + res["snr8"]["calls"]
                             + edge)
    if bad:
        raise AssertionError(f"S1 differs from sync_scan_plain: {bad}")
    return res

def restart_subsets(B: int, nb: int, dev):
    """rmask [B, nb] int8 cycling through every subset of the restarts."""
    import torch
    r = torch.arange(B, device=dev)[:, None] >> torch.arange(nb, device=dev)
    return (r & 1).to(torch.int8)


def k1_edge_rows(code, x, tab):
    """K1's edge cases on rows x [B, K] int8 and tab [B]: every fifth
    row all erasures (pure ties to the end), every fifth from the second
    zero on every position feeding the steps before the first boundary
    (the first 40 steps where there is none: a 16-way tie there), rmask
    cycling through every restart subset. Returns (x, tab, rm)."""
    import torch
    x = x.clone()
    x[::5] = 0
    first = code.boundaries[0] if code.boundaries else 40
    idx = code.pidx.long()[tab[1::5].long(), :4 * first]
    fed = torch.zeros(x[1::5].shape, dtype=torch.int32, device=x.device)
    fed.scatter_add_(1, idx.clamp(min=0), (idx >= 0).to(torch.int32))
    x[1::5] = torch.where(fed > 0, 0, x[1::5]).to(torch.int8)
    return x, tab, restart_subsets(x.shape[0], len(code.boundaries),
                                   x.device)


def k4_edge_rows(x, n_sym: int, bnd: tuple):
    """K4's edge cases on soft rows x [B, >= 4 n_sym] f32: every fifth
    row all erasures, every fifth from the second zero before the first
    boundary (before n_sym // 2 where there is none), rmask cycling
    through every restart subset. Returns (x, rm)."""
    x = x.clone()
    x[::5] = 0
    x[1::5, :4 * (bnd[0] if bnd else n_sym // 2)] = 0
    return x, restart_subsets(x.shape[0], len(bnd), x.device)


def k1_edge_mismatches(code, x, tab) -> int:
    """Bits and CRC flags of K1 that differ from its plain version on
    k1_edge_rows of the first RAGGED rows of (x, tab)."""
    from tetra_tpu_torch.ops.viterbi_assembled import decode_assembled_plain
    bad = 0
    for B in RAGGED:
        xe, te, re = k1_edge_rows(code, x[:B], tab[:B].contiguous())
        bk, ok_k = code(xe, te, re)
        bp, ok_p = decode_assembled_plain(xe, code.pidx, te, re, code.n_sym,
                                          code.boundaries, code.crc_segs)
        bad += int((bk != bp).sum()) + int((ok_k != ok_p).sum())
    return bad


def k4_edge_mismatches(x, n_sym: int, bnd: tuple) -> int:
    """Bits of K4 that differ from its plain version on k4_edge_rows of
    the first RAGGED rows of x."""
    from tetra_tpu_torch.ops.viterbi import decode_segmented
    from tetra_tpu_torch.ops.viterbi_segmented import decode_segmented_k4
    bad = 0
    for B in RAGGED:
        xe, re = k4_edge_rows(x[:B], n_sym, bnd)
        bad += int((decode_segmented_k4(xe, re, n_sym, bnd)
                    != decode_segmented(xe, re, n_sym, bnd)).sum())
    return bad


def check_k1(dev, n_rows: int) -> dict:
    """K1 vs its plain version at n_sym 288 (fused decode), 80 (SB1) and
    144 (SB2 and NDB) on random signs and on corrupted real slots, and on
    k1_edge_rows of the random signs (tab mixing every map at n288) at
    each RAGGED row count."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import constants as C
    from tetra_tpu_torch.lmac.fused import assemble_parts, fused_tables
    from tetra_tpu_torch.lmac.pipeline import _block_decoder
    from tetra_tpu_torch.ops.scramble import keystream_np
    from tetra_tpu_torch.ops.viterbi_assembled import decode_assembled_plain
    init = ((42 << 6 | 262 << 20 | 1) << 2) | C.SCRAMB_INIT
    tables = fused_tables(dev)
    g = torch.Generator(device="cpu").manual_seed(7)
    slots, kinds = slot_batch(n_rows, dev)
    inits = torch.full((n_rows,), init, dtype=torch.int64, device=dev)
    x, tab, rm, _ = assemble_parts(slots, inits, kinds, tables)
    xr = torch.randint(-1, 2, x.shape, generator=g).to(torch.int8).to(dev)
    tabr = torch.randint(0, 3, (n_rows,), generator=g).to(torch.int32).to(dev)
    rmr = tables.rmask[tabr.to(torch.int64)]
    res = {"rows": n_rows}
    worst = 0
    max_abs = 0
    n_ok = 0
    # per-kind blocks: (K1 shape, block kind, slot offset, scrambling code)
    blocks = {"n80": ("SB1", C.SB_BLK1_OFFSET, C.SCRAMB_INIT),
              "n144": ("NDB", C.NDB_BLK1_OFFSET, init)}
    for name, code, cases in (
            ("n288", tables.code, [(x, tab, rm), (xr, tabr, rmr)]),
            ("n80", _block_decoder("SB1", dev).code, None),
            ("n144", _block_decoder("NDB", dev).code, None)):
        if cases is None:
            kind, off, code_init = blocks[name]
            n345 = C.BLOCK_PARAMS[kind][0]
            ks = torch.as_tensor(keystream_np(code_init, n345)
                                 .astype("int8"), device=dev)
            t5 = slots[:, off:off + n345]
            sgn = (1 - 2 * (t5 ^ ks)).to(torch.int8).contiguous()
            z = torch.zeros(n_rows, dtype=torch.int32, device=dev)
            r0 = torch.zeros((n_rows, 0), dtype=torch.int8, device=dev)
            sgr = torch.randint(-1, 2, sgn.shape, generator=g) \
                .to(torch.int8).to(dev)
            cases = [(sgn, z, r0), (sgr, z, r0)]
        for xi, ti, ri in cases:
            bk, ok_k = code(xi, ti, ri)
            bp, ok_p = decode_assembled_plain(xi, code.pidx, ti, ri,
                                              code.n_sym, code.boundaries,
                                              code.crc_segs)
            worst = max(worst, int((bk != bp).sum()),
                        int((ok_k != ok_p).sum()))
            max_abs = max(max_abs, int((bk - bp).abs().max()),
                          int((ok_k - ok_p).abs().max()))
            n_ok += int(ok_k.sum())
        edge = k1_edge_mismatches(code, *cases[-1][:2])
        res[f"edge_mismatches_{name}"] = edge
        worst = max(worst, edge)
        xi, ti, ri = cases[0]
        res[f"bound_{name}"] = bound(
            xi.numel() + 4 * ti.numel() + ri.numel()
            + n_rows * (code.n_sym + len(code.crc_segs)),
            viterbi_ops(n_rows, code.n_sym, 4) + n_rows * code.n_sym,
            INT32_OPS)
        res[f"ms_{name}"] = cuda_ms(lambda: code(xi, ti, ri))
        res[f"plain_ms_{name}"] = cuda_ms(
            lambda: decode_assembled_plain(xi, code.pidx, ti, ri, code.n_sym,
                                           code.boundaries, code.crc_segs),
            reps=2)
    res["mismatches"] = worst
    res["max_abs_err"] = max_abs
    res["crc_ok_flags"] = n_ok
    if worst:
        raise AssertionError(f"K1 differs from its plain version: {res}")
    return res


def k3_library(xr, xi, W, bmin: int, L: int, Mph: int, n_out: int):
    """K3's function as one PyTorch call, the yardstick timed beside the
    kernel (library_ms; the port never calls it): conv2d of the two
    planes stacked as [2, 1, rows, C], padded once beforehand so that
    row 0 is input row bmin, with W's Mph columns as filters [Mph, 1,
    width, 1] at stride (L, 1): out[p, r, q, c] = y_p[q·Mph + r, c].
    Returns (call, unpack): call() runs the convolution alone and
    unpack(out) gives its ([n_out, C], [n_out, C]). n_out >= 1."""
    import torch
    import torch.nn.functional as F
    C, width = xr.shape[1], W.shape[0]
    nq = -(-n_out // Mph)
    x = torch.stack([xr, xi])[:, None]
    x = F.pad(x, (0, 0, -bmin, 0)) if bmin < 0 else x[:, :, bmin:]
    x = F.pad(x, (0, 0, 0, max((nq - 1) * L + width - x.shape[2], 0)))
    w = W.T[:, None, :, None].contiguous()

    def unpack(out):
        y = out[:, :, :nq].permute(0, 2, 1, 3).reshape(2, nq * Mph, C)
        return y[0, :n_out], y[1, :n_out]

    return (lambda: F.conv2d(x, w, stride=(L, 1))), unpack


def k3_bound(n_in: int, c_sel: int, n_out: int) -> dict:
    """K3: c_sel columns of both planes' rows in, [n_out, c_sel] x2 out;
    per output and channel 8 live taps of a complex row (4 ops each)."""
    return bound(8 * n_in * c_sel + 8 * n_out * c_sel,
                 n_out * c_sel * 4 * 8, F32_FLOPS)


def check_k3(dev, fe, yr, yi, subset_seed: int) -> dict:
    """K3 on K2's rows (yr, yi) against its plain versions in both
    layouts: time-major (resample_rows_plain), channel-major over all
    channels and over a permuted half of them as int64 and int32
    (resample_channels_plain); each within TOL x max|plain|. Times of
    the kernel in each layout, of the plain versions, of the conv2d
    yardstick (k3_library, checked against the plain version first) and
    of the layout copies the front end made before K3 wrote
    channel-major (the gather of the subset's columns and the two
    transposes, `layout_copy_ms`)."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch.phy.pfb import (resample_channels_plain,
                                         resample_rows, resample_rows_plain)
    n_in, C = yr.shape
    n_out = fe.n_out(n_in)
    g = torch.Generator().manual_seed(subset_seed)
    sub = torch.randperm(C, generator=g)[:max(C // 2, 1)].to(dev)
    args = (fe.rs_taps, fe.rs_off, fe.W, fe.bmin, fe.L, fe.M, n_out)
    plain = (fe.W, fe.bmin, fe.L, fe.M, n_out)
    cases = {
        "rows": (lambda: resample_rows(yr, yi, *args),
                 lambda: resample_rows_plain(yr, yi, *plain), C),
        "channels": (lambda: resample_rows(yr, yi, *args,
                                           channel_major=True),
                     lambda: resample_channels_plain(yr, yi, *plain), C),
        "subset": (lambda: resample_rows(yr, yi, *args, channel_major=True,
                                         channel_idx=sub),
                   lambda: resample_channels_plain(yr, yi, *plain, sub),
                   len(sub))}
    sub32 = sub.to(torch.int32)
    res = {"n_chan": C, "frames": n_in, "n_out": n_out,
           "subset_channels": len(sub)}
    worst = 0.0
    for name, (kern, pl, c_sel) in cases.items():
        want = pl()
        d, s = rel_err(kern(), want)
        if name == "subset":
            d32, _ = rel_err(resample_rows(yr, yi, *args, channel_major=True,
                                           channel_idx=sub32), want)
            d = max(d, d32)
        del want
        b = k3_bound(n_in, c_sel, n_out)
        ms = cuda_ms(kern)
        res[name] = {"max_abs_err": d, "max_abs_plain": s, "ms": ms,
                     "plain_ms": cuda_ms(pl, 2), "share_of_bound":
                     b["bound_ms"] / ms, "bound": b}
        worst = max(worst, d / s)
    call, unpack = k3_library(yr, yi, fe.W, fe.bmin, fe.L, fe.M, n_out)
    d, s = rel_err(unpack(call()), resample_rows_plain(yr, yi, *plain))
    res["library"] = {"call": "torch.nn.functional.conv2d",
                      "max_abs_err": d, "max_abs_plain": s,
                      "ms": cuda_ms(call)}
    worst = max(worst, d / s)
    torch.cuda.empty_cache()
    out_r, out_i = resample_rows(yr, yi, *args)
    res["layout_copy_ms"] = {
        "transposes": cuda_ms(lambda: (out_r.T.contiguous(),
                                       out_i.T.contiguous())),
        "subset_gather": cuda_ms(lambda: (yr[:, sub].contiguous(),
                                          yi[:, sub].contiguous()))}
    del out_r, out_i
    res["within_tol"] = worst <= TOL
    if not res["within_tol"]:
        raise AssertionError(f"K3 or its yardstick outside tolerance: {res}")
    return res


def check_pfb(dev, n_chan: int, T: int, seed: int) -> dict:
    """K2 and K3 vs their plain versions on Gaussian wideband noise (K3
    on K2's plain rows: check_k3)."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch.phy.pfb import (PfbFrontEnd, pfb_channelize_rows,
                                         pfb_channelize_rows_plain)
    fe = PfbFrontEnd(n_chan, 25_000.0 * n_chan).to(dev)
    g = torch.Generator(device="cpu").manual_seed(seed)
    re = torch.randn(T, generator=g).to(dev)
    im = torch.randn(T, generator=g).to(dev)
    k2 = lambda: pfb_channelize_rows(re, im, fe.h, fe.twc, fe.tws, n_chan,
                                     fe.J)
    p2 = lambda: pfb_channelize_rows_plain(re, im, fe.h, n_chan, fe.J)
    yk, yp = k2(), p2()
    d2, s2 = rel_err(yk, yp)
    del yk
    yr, yi = yp
    frames = int(yr.shape[0])
    # the DFT stage alone, for reference: torch.fft.fft over the [M, C]
    # complex frames (it does not compute K2's function: no window, no
    # hop rotation)
    z = torch.complex(yr, yi)
    dft_ms = cuda_ms(lambda: torch.fft.fft(z, dim=1))
    del z
    res = {"n_chan": n_chan, "samples": T, "frames": frames,
           "k2_bound": k2_bound(n_chan, T, frames, fe.J),
           "k2_max_abs_err": d2, "k2_max_abs_plain": s2,
           "k2_ms": cuda_ms(k2), "k2_plain_ms": cuda_ms(p2, 2),
           "k2_dft_only_ms": dft_ms}
    if not d2 <= TOL * s2:
        raise AssertionError(f"K2 outside tolerance: {res}")
    k3 = check_k3(dev, fe, yr, yi, seed)
    # the front end's layout (channel-major over all channels) is K3's
    # main-path entry
    main = k3["channels"]
    res.update({"k3": k3, "n_out": k3["n_out"],
                "k3_max_abs_err": max(k3[k]["max_abs_err"]
                                      for k in ("rows", "channels",
                                                "subset")),
                "k3_ms": main["ms"], "k3_plain_ms": main["plain_ms"],
                "k3_bound": main["bound"],
                "k3_share_of_bound": main["share_of_bound"],
                "k3_library_ms": k3["library"]["ms"]})
    return res


def soft_slot_rows(dev, n_car: int = 64):
    """Real soft FEC rows: the snr8 capture at n_car carriers through the
    soft front end (K2, K3, soft demod), the tolerant sync scan on its
    hard decisions, and every emitted slot assembled to mother order.
    Returns (soft [n, 1152] float32, rm [n, 3] int8) on dev."""
    import torch
    from tetra_tpu_torch import constants as C
    from tetra_tpu_torch import fastpath, prod_fixture
    from tetra_tpu_torch.lmac.fused import assemble_soft, fused_tables
    from tetra_tpu_torch.phy.sync_vec import sync_scan
    raw = torch.as_tensor(prod_fixture.snr8_capture(n_car)).to(dev)
    soft = fastpath._iq_frontend(raw, None, "iq4c", n_car, 25_000.0 * n_car,
                                 2, soft=True)
    z = torch.zeros(n_car, dtype=torch.int32, device=dev)
    _, out = sync_scan((soft < 0).to(torch.int8), z, z, z, z, z, 0,
                       soft.shape[1] // 64, tol=2)
    t, c = torch.nonzero(out["emit"], as_tuple=True)
    pos = (c * soft.shape[1] + out["slot"][t, c])[:, None] \
        + torch.arange(C.BITS_PER_TS, device=dev)
    rows = soft.reshape(-1)[pos].to(torch.float32)
    kinds = out["col"][t, c].to(torch.int64)
    init = ((42 << 6 | 262 << 20 | 1) << 2) | C.SCRAMB_INIT
    inits = torch.full_like(kinds, init)
    x, rm, _ = assemble_soft(rows, inits, kinds, fused_tables(dev))
    return x, rm


def check_k4(dev, n_rows: int) -> dict:
    """K4 vs its plain version: n_sym 288 with restarts at (80, 144,
    224) on n_rows rows (half real soft slots of the snr8 capture, the
    rest random soft values of the path's alphabet (int8 x 127, ~3/8
    erasures) and dyadic fractions, random restart masks), and n_sym 80
    without restarts at the CPU test's shape [32, 320]; then
    k4_edge_rows of real and random rows at each RAGGED row count, at
    n_sym 288, 80, 77 (two restarts) and 292. Bits must be identical."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch.lmac.fused import BOUNDARIES, N_SYM
    from tetra_tpu_torch.ops.viterbi import decode_segmented
    from tetra_tpu_torch.ops.viterbi_segmented import decode_segmented_k4
    g = torch.Generator(device="cpu").manual_seed(11)
    real, rm_real = soft_slot_rows(dev)
    n_real = n_rows // 2
    pick = torch.randint(0, real.shape[0], (n_real,), generator=g).to(dev)
    n_rand = n_rows - n_real
    n_dy = n_rand // 8
    rand = (torch.randint(-124, 125, (n_rand, 4 * N_SYM), generator=g)
            * 127).to(torch.float32)
    rand[torch.rand(rand.shape, generator=g) < 0.375] = 0
    rand[:n_dy] = torch.randint(-8, 9, (n_dy, 4 * N_SYM),
                                generator=g).to(torch.float32) * 0.25
    x = torch.cat([real[pick], rand.to(dev)]).contiguous()
    rm = torch.cat([rm_real[pick],
                    torch.randint(0, 2, (n_rand, 3), generator=g)
                    .to(torch.int8).to(dev)]).contiguous()
    x80 = rand[n_dy:n_dy + 32, :320].contiguous().to(dev)
    rm80 = torch.zeros((32, 0), dtype=torch.int8, device=dev)
    res = {"rows": n_rows, "real_rows": n_real,
           "distinct_real_slots": int(real.shape[0])}
    # edge cases: real and random rows interleaved, at n288 with the
    # path's restarts, n80, n77 with two restarts and TCH/4.8's n292
    half = max(RAGGED) // 2 + 1
    mix = torch.stack([x[:half], x[n_real:n_real + half]], 1) \
        .reshape(-1, 4 * N_SYM)
    wide = torch.cat([mix, mix[:, :16]], 1)
    for name, ns, bnd in (("n288", N_SYM, BOUNDARIES), ("n80", 80, ()),
                          ("n77", 77, (20, 52)),
                          ("n292", 292, (80, 144, 224))):
        src = wide[:, :4 * ns].contiguous()
        res[f"edge_mismatches_{name}"] = k4_edge_mismatches(src, ns, bnd)
    worst = max(res[k] for k in res if k.startswith("edge_"))
    for name, xi, ri, ns, bnd in (("n288", x, rm, N_SYM, BOUNDARIES),
                                  ("n80", x80, rm80, 80, ())):
        bk = decode_segmented_k4(xi, ri, ns, bnd)
        bp = decode_segmented(xi, ri, ns, bnd)
        res[f"mismatches_{name}"] = int((bk != bp).sum())
        worst = max(worst, int((bk.int() - bp.int()).abs().max()))
        res[f"bound_{name}"] = bound(
            4 * xi.shape[0] * 4 * ns + ri.numel() + xi.shape[0] * ns,
            viterbi_ops(xi.shape[0], ns, 4), F32_OPS)
        res[f"ms_{name}"] = cuda_ms(lambda: decode_segmented_k4(xi, ri, ns,
                                                                bnd))
        res[f"plain_ms_{name}"] = cuda_ms(
            lambda: decode_segmented(xi, ri, ns, bnd), reps=2)
    res["max_abs_err"] = worst
    if res["mismatches_n288"] or res["mismatches_n80"] \
            or any(res[k] for k in res if k.startswith("edge_")):
        raise AssertionError(f"K4 differs from its plain version: {res}")
    return res


def k6_edge_rows(x, n_sym: int, n_gen: int):
    """K6's edge cases on soft rows x [B, n_sym*N] f32: every fifth row
    all erasures (pure ties to the end), every fifth from the second zero
    before step n_sym // 2 (a 16-way tie there), every fifth from the
    third multiples of 0.25 in [-2, 2] (not integers; every f32 sum still
    exact)."""
    import torch
    x = x.clone()
    x[::5] = 0
    x[1::5, :n_gen * (n_sym // 2)] = 0
    g = torch.Generator(device="cpu").manual_seed(x.shape[0] + n_sym)
    x[2::5] = (torch.randint(-8, 9, x[2::5].shape, generator=g)
               * 0.25).to(x.device)
    return x


def k6_rows(rows: int, n_sym: int, n_gen: int, seed: int, dev):
    """rows x n_sym*N soft values of the voice alphabet (+-127 or 0 at
    random), the first half erasure-heavy (90% zeros), on dev."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = n_sym * n_gen
    x = (torch.randint(-1, 2, (rows, w), generator=g) * 127).float()
    half = rows // 2
    x[:half][torch.rand((half, w), generator=g) < 0.9] = 0
    return x.to(dev)


# K6's shapes: n_sym -> code (TCH/S classes 1 and 2, odd n_sym of both
# codes, TCH/4.8), and its row counts that fill no block, warp or wave
K6_SHAPES = {112: "tch", 72: "tch", 77: "cch", 113: "tch", 71: "tch",
             292: "cch"}
K6_RAGGED = (1, 3, 17, 1000, 2000, 3001, 3072)


def check_k6(dev, voice_rows: list) -> dict:
    """K6 vs its plain version, bits identical: at the voice pass's own
    per-launch row counts (`voice_rows`, one chunk's full frames or NDB
    halves, counted from the voice phase) at n_sym 112 and 72 (speech
    code, the voice alphabet), and on k6_edge_rows at every K6_RAGGED
    row count and K6_SHAPES n_sym. Times of both at the voice counts,
    at K6_ROWS (n112, n72) and at 256 rows (n77, n113, n292): CUDA
    events over back-to-back calls (`ms`, which the wrapper's host time
    sets at these sizes) and the kernel's own time from torch.profiler
    (`device_ms`); and of an empty kernel launch: the floor of any
    one-launch design, K6's bound being below it."""
    import torch
    from bench_torch_kernels import device_ms
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import constants as C
    from tetra_tpu_torch import kernels
    from tetra_tpu_torch.ops.viterbi import decode
    from tetra_tpu_torch.ops.viterbi_decode import decode_k6
    codes = {"tch": C.CONV_GENERATORS_TCH, "cch": C.CONV_GENERATORS_CCH}
    res = {"rows": K6_ROWS, "voice_rows": sorted(set(voice_rows))}
    worst = 0

    def compare(x, n_sym, gens) -> int:
        nonlocal worst
        bk, bp = decode_k6(x, n_sym, gens), decode(x, n_sym, gens)
        worst = max(worst, int((bk.int() - bp.int()).abs().max()))
        return int((bk != bp).sum())

    edge = 0
    for n_sym, code in K6_SHAPES.items():
        gens = codes[code]
        for rows in K6_RAGGED:
            x = k6_rows(rows, n_sym, len(gens), rows + n_sym, dev)
            edge += compare(k6_edge_rows(x, n_sym, len(gens)), n_sym, gens)
    res["edge_mismatches"] = edge
    timed = [(f"n{n}_{r}", r, n, "tch") for r in res["voice_rows"]
             for n in (112, 72)]
    timed += [("n112", K6_ROWS, 112, "tch"), ("n72", K6_ROWS, 72, "tch"),
              ("n77", 256, 77, "cch"), ("n113", 256, 113, "tch"),
              ("n292", 256, 292, "cch")]
    for name, rows, n_sym, code in timed:
        gens = codes[code]
        w = n_sym * len(gens)
        x = k6_rows(rows, n_sym, len(gens), 13 + rows + n_sym, dev)
        x[:8] = 0
        res[f"mismatches_{name}"] = compare(x, n_sym, gens)
        res[f"bound_{name}"] = bound(4 * rows * w + rows * n_sym,
                                     viterbi_ops(rows, n_sym, len(gens)),
                                     F32_OPS)
        res[f"ms_{name}"] = cuda_ms(lambda: decode_k6(x, n_sym, gens))
        res[f"device_ms_{name}"] = device_ms(lambda: decode_k6(x, n_sym,
                                                               gens), 10)
        res[f"plain_ms_{name}"] = cuda_ms(lambda: decode(x, n_sym, gens),
                                          reps=2)
    stream = kernels.stream_ptr(dev)
    res["empty_launch_ms"] = cuda_ms(
        lambda: kernels.check(kernels.lib().tt_empty_launch(stream),
                              "tt_empty_launch"), reps=100)
    res["max_abs_err"] = worst
    if edge or any(res[k] for k in res if k.startswith("mismatches_")):
        raise AssertionError(f"K6 differs from its plain version: {res}")
    return res


def counts(mrx) -> dict:
    import numpy as np
    from tetra_tpu_torch.umac.native_exec import EV
    kinds = np.concatenate([e["kind"] for e in mrx.native_events])
    return {"crc_ok": sum(c.stats.crc_ok for c in mrx.carriers),
            "crc_err": sum(c.stats.crc_wrong for c in mrx.carriers),
            "traffic_slots": int((kinds == EV.TRAFFIC).sum()),
            "tl_sdus": int((kinds == EV.TLSDU).sum()),
            "frag_ends": int((kinds == EV.FRAG_END).sum())}


def card_vs_cpu(packed, ks_path, dev, demod: str = "hard"):
    """An 8-carrier capture through the receiver on the card and on the
    CPU (plain versions): (card receiver, per-carrier stats equal,
    native event arrays equal)."""
    import numpy as np
    from tetra_tpu_torch import prod_fixture
    gpu, _ = prod_fixture.run_receiver(packed, 8, ks_path, dev, 2, demod)
    cpu, _ = prod_fixture.run_receiver(packed, 8, ks_path, "cpu", 2, demod)
    st = lambda m: [(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
                    for c in m.carriers]
    same_ev = all(
        np.array_equal(np.concatenate([e[k] for e in gpu.native_events]),
                       np.concatenate([e[k] for e in cpu.native_events]))
        for k in ("carrier", "kind", "a", "b", "c", "d", "payload"))
    return gpu, st(gpu) == st(cpu), bool(same_ev)


def check_small(ks_path: str, dev) -> dict:
    """8 carriers at fs = 200 kHz (the CPU tests' production fixture):
    the receiver on the card equals the receiver on the CPU."""
    from tetra_tpu_torch import prod_fixture
    bits, _ = prod_fixture.mixed_bits(8, 0.25)
    gpu, same_st, same_ev = card_vs_cpu(prod_fixture.wideband_capture(bits),
                                        ks_path, dev)
    res = {"carriers": 8, "stats_equal": same_st, "events_equal": same_ev,
           **counts(gpu)}
    if not (res["stats_equal"] and res["events_equal"]
            and res["crc_err"] == 0 and res["crc_ok"] > 0):
        raise AssertionError(f"small capture: card and CPU differ: {res}")
    return res


def check_voice_small(ks_path: str, dev) -> dict:
    """The 8-carrier capture with traffic dumps, voice decode, GSMTAP
    and a TL-SDU sink on the card and on the CPU: identical files,
    packets and sink calls."""
    import tempfile
    import udp_sink
    from tetra_tpu_torch import prod_fixture
    bits, _ = prod_fixture.mixed_bits(8, 0.25)
    packed = prod_fixture.wideband_capture(bits)
    outs = []
    for d in (dev, "cpu"):
        calls = []
        sink = lambda c, pd, pt, b: calls.append((c, pd, pt, b.tobytes()))
        with tempfile.TemporaryDirectory() as tmp, \
                udp_sink.collect() as udp:
            prod_fixture.run_receiver(packed, 8, ks_path, d, 2,
                                      gsmtap_addr=udp.addr,
                                      dumpdir=tmp, decode_voice=True,
                                      gsmtap_host="127.0.0.1",
                                      tl_sdu_sink=sink)
            files = prod_fixture.read_tree(tmp)
        outs.append((files, udp.packets, calls))
    (fg, pg, cg), (fc, pc, cc) = outs
    res = {"carriers": 8, "files": len(fg),
           "voice_bytes": sum(len(v) for k, v in fg.items()
                              if k.endswith(".cod")),
           "gsmtap_packets": len(pg), "sink_calls": len(cg),
           "files_equal": fg == fc, "packets_equal": pg == pc,
           "sink_calls_equal": cg == cc}
    if not (res["files_equal"] and res["packets_equal"]
            and res["sink_calls_equal"] and res["voice_bytes"] > 0
            and res["gsmtap_packets"] > 0 and res["sink_calls"] > 0):
        raise AssertionError(f"voice_small: card and CPU differ: {res}")
    return res


def check_rx_small(ks_path: str, dev, fx: dict) -> dict:
    """tetra_tpu_torch.rx.TetraReceiver (keystore, dumps, voice) on one
    carrier of the 8-carrier capture (prod_fixture.rx_small_bits), on
    the card and on the CPU, each fed in 3 chunks with final=False and
    an empty final call, and in one call: log lines, stats, TMV records
    and dump/.cod files identical, and equal to the JAX receiver's record
    in the fixture (prod_fixture.python_record). Launch counts of the
    card's one-call run."""
    import tempfile
    import numpy as np
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.rx import TetraReceiver
    bits = P.rx_small_bits(fx)
    rec = P.python_record(fx)["rx_small"]
    runs, n_launch = {}, {}
    for d in (dev, "cpu"):
        for mode in ("chunks", "whole"):
            lines = []
            with tempfile.TemporaryDirectory() as tmp:
                r = TetraReceiver(keystore_path=ks_path, dumpdir=tmp,
                                  decode_voice=True,
                                  log=P.line_logger(lines), device=d)
                r.tmv_records = []
                if mode == "chunks":
                    for part in np.array_split(bits, 3):
                        r.process_bits(part, final=False)
                    r.process_bits(bits[:0], final=True)
                else:
                    if d is dev:
                        reset_launches()
                    r.process_bits(bits)
                    if d is dev:
                        n_launch = launches()
                files = P.read_tree(tmp)
            runs[(str(d), mode)] = (lines, (r.stats.bursts, r.stats.crc_ok,
                                            r.stats.crc_wrong),
                                    P.digest(r.tmv_records), files)
    want = (rec["log"], rec["stats"], rec["tmv"], rec["files"])
    res = {"bits": int(len(bits)), "lines": len(runs[(str(dev), "whole")][0]),
           "stats": runs[(str(dev), "whole")][1],
           "files": len(runs[(str(dev), "whole")][3]),
           "equal_to_cpu": runs[(str(dev), "whole")] == runs[("cpu", "whole")]
           and runs[(str(dev), "chunks")] == runs[("cpu", "chunks")],
           "chunks_equal_whole": runs[(str(dev), "chunks")]
           == runs[(str(dev), "whole")],
           "equal_to_jax_record": {
               k: runs[(str(dev), "whole")][i] == want[i]
               for i, k in enumerate(("log", "stats", "tmv", "files"))},
           "launches": n_launch}
    if not (res["equal_to_cpu"] and res["chunks_equal_whole"]
            and all(res["equal_to_jax_record"].values())):
        raise AssertionError(f"rx_small: card, CPU and the JAX record "
                             f"differ: {res}")
    if n_launch["viterbi_assembled"] <= 0 or n_launch["viterbi_decode"] <= 0:
        raise AssertionError(f"rx_small: K1 or K6 not launched: {n_launch}")
    return res


def check_cli(ks_path: str, fx: dict) -> dict:
    """python3 -m tetra_tpu_torch.rx in subprocesses on the rx_small
    carrier: -f bits on its bits and -f iq on a cfile modulated from
    them (dqpsk.modulate), each with -k, -d and --voice, once on the
    card (the default device) and once with --device cpu. Stdout and
    dump files must be identical; CRC-OK / CRC-WRONG line counts."""
    import tempfile
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.phy import dqpsk
    root = pathlib.Path(__file__).resolve().parent
    bits = P.rx_small_bits(fx)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        caps = {"bits": tmp / "cap.bits", "iq": tmp / "cap.cfile"}
        bits.tofile(caps["bits"])
        dqpsk.modulate(bits, sps=2).tofile(caps["iq"])
        for fmt, cap in caps.items():
            outs = {}
            for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
                d = tmp / f"{fmt}_{name}"
                t0 = time.perf_counter()
                out = subprocess.run(
                    [sys.executable, "-m", "tetra_tpu_torch.rx", *extra,
                     "-f", fmt, "-k", ks_path, "-d", str(d), "--voice",
                     str(cap)], cwd=root, capture_output=True, text=True,
                    timeout=600)
                if out.returncode:
                    raise AssertionError(f"cli {fmt} {name}: rc "
                                         f"{out.returncode}: "
                                         f"{out.stderr[-3000:]}")
                outs[name] = (out.stdout, P.read_tree(d),
                              time.perf_counter() - t0)
            lines = outs["card"][0].splitlines()
            res[fmt] = {
                "crc_ok_lines": sum(ln.startswith("CRC COMP") and
                                    ln.endswith(" OK") for ln in lines),
                "crc_wrong_lines": sum(ln.startswith("CRC COMP") and
                                       ln.endswith(" WRONG") for ln in lines),
                "summary": lines[-1], "files": len(outs["card"][1]),
                "stdout_equal": outs["card"][0] == outs["cpu"][0],
                "files_equal": outs["card"][1] == outs["cpu"][1],
                "card_s": outs["card"][2], "cpu_s": outs["cpu"][2]}
    res.update(check_receiver_cli(ks_path, bits))
    if not all(r["stdout_equal"] and r["files_equal"] and r["crc_ok_lines"]
               and r.get("stderr_equal", True) for r in res.values()):
        raise AssertionError(f"cli: card and CPU differ: {res}")
    return res


def udp_bound(port: int) -> bool:
    """Whether a UDP socket is bound to `port` (Linux /proc/net/udp)."""
    with open("/proc/net/udp") as f:
        return any(int(ln.split()[1].split(":")[1], 16) == port
                   for ln in f.readlines()[1:])


def pcm_s16(iq) -> bytes:
    """Complex samples -> interleaved stereo s16le PCM (I left, Q right)
    at 0.8 of full scale, as an fcdp audio card delivers them."""
    import numpy as np
    inter = np.empty(2 * len(iq), np.float32)
    inter[0::2], inter[1::2] = np.real(iq), np.imag(iq)
    return (inter / np.abs(inter).max() * 0.8 * 32767).astype("<i2").tobytes()


def check_receiver_cli(ks_path: str, bits) -> dict:
    """python3 -m tetra_tpu_torch.receiver in subprocesses on the
    rx_small carrier, once on the card (the default device) and once with
    --device cpu: --file on a cfile modulated from its bits (-k, -d,
    --voice), --udp with its bits sent over loopback in 1024-byte
    datagrams once the receiver has bound its port, and --audio on 96
    kHz s16le PCM with the carrier at +5 kHz (--calibration 5000). The
    log lines (stdout), the stderr summary and the dump files must be
    identical."""
    import socket
    import tempfile
    import numpy as np
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.phy import channelizer, dqpsk
    root = pathlib.Path(__file__).resolve().parent
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        iq36 = dqpsk.modulate(bits, sps=2)
        iq36.tofile(tmp / "cap.cfile")
        (tmp / "cap.s16").write_bytes(pcm_s16(channelizer.synthesize_wideband(
            iq36[None], [5_000.0], fs=96_000.0)))
        modes = {"receiver_file": ["--file", str(tmp / "cap.cfile"), "-k",
                                   ks_path, "--voice"],
                 "receiver_udp": ["--fmt", "bits", "-k", ks_path],
                 "receiver_audio": ["--audio", str(tmp / "cap.s16"),
                                    "--calibration", "5000", "-k", ks_path]}
        for mode, args in modes.items():
            outs = {}
            for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
                d = tmp / f"{mode}_{name}"
                argv = [*args, "-d", str(d), *extra]
                if mode == "receiver_udp":
                    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                        s.bind(("127.0.0.1", 0))
                        port = s.getsockname()[1]
                    argv = ["--udp", str(port), *argv]
                t0 = time.perf_counter()
                proc = subprocess.Popen(
                    [sys.executable, "-m", "tetra_tpu_torch.receiver", *argv],
                    cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                try:
                    if mode == "receiver_udp":
                        while not udp_bound(port):
                            if proc.poll() is not None or \
                                    time.perf_counter() - t0 > 300:
                                break
                            time.sleep(0.1)
                        with socket.socket(socket.AF_INET,
                                           socket.SOCK_DGRAM) as s:
                            for i in range(0, len(bits), 1024):
                                s.sendto(np.asarray(bits[i:i + 1024],
                                                    np.uint8).tobytes(),
                                         ("127.0.0.1", port))
                    out, err = proc.communicate(timeout=600)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                if proc.returncode:
                    raise AssertionError(f"cli {mode} {name}: rc "
                                         f"{proc.returncode}: {err[-3000:]}")
                outs[name] = (out, err.strip().splitlines()[-1],
                              P.read_tree(d) if d.exists() else {},
                              time.perf_counter() - t0)
            lines = outs["card"][0].splitlines()
            res[mode] = {
                "crc_ok_lines": sum(ln.startswith("CRC COMP") and
                                    ln.endswith(" OK") for ln in lines),
                "crc_wrong_lines": sum(ln.startswith("CRC COMP") and
                                       ln.endswith(" WRONG") for ln in lines),
                "summary": outs["card"][1], "files": len(outs["card"][2]),
                "stdout_equal": outs["card"][0] == outs["cpu"][0],
                "stderr_equal": outs["card"][1] == outs["cpu"][1],
                "files_equal": outs["card"][2] == outs["cpu"][2],
                "card_s": outs["card"][3], "cpu_s": outs["cpu"][3]}
    return res


MIXER_CUTS = [4097, 11_003, 23_456]   # the JAX mixer test's cuts
EV_KEYS = ("carrier", "kind", "a", "b", "c", "d", "payload")


def mixer_small_run(dev, fxm: dict, plane: str, cuts=None) -> dict:
    """The JAX mixer test's two-cell capture at 144 kHz (carriers at
    -31,400 and +13,700 Hz) through a mixer-bank MultiCarrierReceiver
    on `plane`, whole or cut at `cuts`: per-carrier stats (bursts, slots,
    crc_ok, crc_wrong), cells, RESOURCE SSIs, log lines and the native
    event arrays."""
    import numpy as np
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    from tetra_tpu_torch.umac.native_exec import EV
    wide, offs, fs = P.small_capture(fxm)
    logs = [[], []]
    m = MultiCarrierReceiver(offs, fs=fs, control_plane=plane, device=dev,
                             log=[P.line_logger(lg) for lg in logs])
    edges = [0] + [c for c in (cuts or []) if c < len(wide)] + [len(wide)]
    for i in range(len(edges) - 1):
        m.process_iq(wide[edges[i]:edges[i + 1]], final=i == len(edges) - 2)
    out = {"stats": [(c.stats.bursts, c.stats.slots, c.stats.crc_ok,
                      c.stats.crc_wrong) for c in m.carriers],
           "cells": [(c.mcc, c.mnc, c.colour_code) for c in m.carriers],
           "logs": logs, "events": None}
    if plane == "python":
        out["ssis"] = [[e[1].addr.ssi for e in c.umac.events
                        if e[0] == "RESOURCE" and e[1].addr.type == 1]
                       for c in m.carriers]
    else:
        ev = {k: np.concatenate([e[k] for e in m.native_events])
              for k in EV_KEYS}
        res = (ev["kind"] == EV.RESOURCE) & (ev["a"] == 1)
        out["ssis"] = [ev["b"][res & (ev["carrier"] == c)].tolist()
                       for c in range(2)]
        out["events"] = ev
    return out


def check_mixer_small(dev, fxm: dict) -> dict:
    """The two-cell off-grid capture on both planes: the card equals the
    CPU (stats, log lines, native event arrays), the card's run cut at
    MIXER_CUTS equals its whole run, and stats, cells and SSIs equal the
    JAX record (prod_fixture.mixer_record "small"); K1 launched."""
    import numpy as np
    from tetra_tpu_torch import prod_fixture as P
    rec = P.mixer_record(fxm)["small"]
    want = {"stats": [r[0] for r in rec], "cells": [r[1] for r in rec],
            "ssis": [list(r[2]) for r in rec]}
    res = {}
    for plane in ("python", "native"):
        reset_launches()
        card = mixer_small_run(dev, fxm, plane)
        n_launch = launches()
        cpu = mixer_small_run("cpu", fxm, plane)
        cut = mixer_small_run(dev, fxm, plane, MIXER_CUTS)
        same_ev = (plane == "python" or all(
            np.array_equal(card["events"][k], cpu["events"][k])
            for k in EV_KEYS))
        keys = ("stats", "cells", "ssis", "logs")
        res[plane] = {
            "stats": card["stats"], "cells": card["cells"],
            "ssis": card["ssis"],
            "log_lines": sum(len(lg) for lg in card["logs"]),
            "card_equals_cpu": all(card[k] == cpu[k] for k in keys)
            and same_ev,
            "chunked_equals_whole": all(card[k] == cut[k] for k in keys),
            "equals_jax_record": all(card[k] == want[k] for k in want),
            "launches": n_launch}
    if not all(r["card_equals_cpu"] and r["chunked_equals_whole"]
               and r["equals_jax_record"]
               and r["launches"]["viterbi_assembled"] > 0
               for r in res.values()):
        raise AssertionError(f"mixer_small: {res}")
    return res


def mixer_cli(u8, fs: float, carriers: str, ks_path, plane: str, dev,
              log=None, n: int | None = None):
    """One run of the live CLI (tetra_tpu_torch.receiver.main --rtltcp)
    against a mock rtl_tcp server process serving `u8`, streaming n
    complex samples (all of u8 by default) after any scan; plane
    "python" is the CLI default. Returns (receiver, wall seconds from
    the call to its return after a synchronize, server commands)."""
    import torch
    import rtl_tcp_mock
    from tetra_tpu_torch import receiver
    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n = len(u8) // 2 if n is None else n
    with rtl_tcp_mock.serve(u8) as srv:
        argv = ["--rtltcp", f"127.0.0.1:{srv.port}", "--rate", str(int(fs)),
                f"--carriers={carriers}", "--secs", repr((n + 0.5) / fs)]
        argv += ["-k", ks_path] if ks_path else []
        argv += ["--control-plane", "native"] if plane == "native" else []
        argv += ["--device", "cpu"] if dev.type == "cpu" else []
        sync()
        t0 = time.perf_counter()
        mrx = receiver.main(argv, log=log)
        sync()
        wall = time.perf_counter() - t0
    return mrx, wall, srv.commands


def mixer_split(dev, u8, offsets, fs: float) -> dict:
    """Device time (CUDA events, mean of 5 after a warm-up) of each stage
    of the mixer front end on one continuation chunk of the mixer pass
    (the 2 x BLOCK history + the BLOCK-aligned 0.5 s): oscillator mix,
    127-tap FIR (both planes), resampler (both planes), hard demod at
    os=4; and the front end's time per pass, estimated from the chunk's
    cost per new sample."""
    import numpy as np
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.io.sdr import RtlTcpSource
    from tetra_tpu_torch.phy import channelizer as ch, dqpsk
    from tetra_tpu_torch.rx_multi import mixer_block
    block = mixer_block(fs)[0]
    new = (P.MIXER_CHUNK // block) * block
    n_feed = 2 * block + new
    iq = RtlTcpSource._to_complex(u8[:2 * n_feed])
    raw = torch.as_tensor(np.ascontiguousarray(iq).view(np.float32),
                          device=dev)
    re, im = raw[0::2].contiguous(), raw[1::2].contiguous()
    taps = ch.design_lowpass(fs, ch.CUTOFF, 127)
    base = P.MIXER_CHUNK
    mr, mi = ch._mix_ri(re, im, offsets, fs, base)
    fr, fi = ch._fir_real(mr, taps), ch._fir_real(mi, taps)
    cr = ch._resample_ri_one(fr, n_feed, fs, ch.DEMOD_RATE)
    ci = ch._resample_ri_one(fi, n_feed, fs, ch.DEMOD_RATE)
    ms = {"mix": cuda_ms(lambda: ch._mix_ri(re, im, offsets, fs, base), 5),
          "fir": cuda_ms(lambda: (ch._fir_real(mr, taps),
                                  ch._fir_real(mi, taps)), 5),
          "resample": cuda_ms(lambda: (
              ch._resample_ri_one(fr, n_feed, fs, ch.DEMOD_RATE),
              ch._resample_ri_one(fi, n_feed, fs, ch.DEMOD_RATE)), 5),
          "demod": cuda_ms(lambda: dqpsk.demodulate_hard_ri(cr, ci, sps=2,
                                                           os=4), 5)}
    # the composed stages are channelize_ri + the demod
    bits = dqpsk.demodulate_hard_ri(cr, ci, sps=2, os=4)
    whole = dqpsk.demodulate_hard_ri(*ch.channelize_ri(
        re, im, offsets, fs, base=base), sps=2, os=4)
    if not torch.equal(bits, whole):
        raise AssertionError("mixer_split: the stages differ from "
                             "channelize_ri")
    chunk_ms = sum(ms.values())
    return {"feed_samples": n_feed, "new_samples": new,
            "carriers": len(offsets), "ms": ms, "chunk_ms": chunk_ms,
            "pass_ms_est": chunk_ms * (len(u8) // 2) / new}


def run_mixer(ks_path: str, dev, fx: dict, fxm: dict, card: str,
              record: list | None = None):
    """mixer-64, the live CLI end to end at full width: a mock rtl_tcp
    server process serves the 64-carrier off-grid u8 capture
    (prod_fixture.mixer_capture, 1.8 MS/s, 1.0346 s), and
    tetra_tpu_torch.receiver.main --rtltcp --rate 1800000 --carriers
    <64 offsets> -k <keystore> runs once warm and once timed on each
    plane (the Python plane, the CLI default, with log lines kept on
    MIXER_LOG_CHANNELS). Every carrier's (bursts, crc_ok, crc_wrong)
    and cell equal the JAX mixer record, the 4 log digests equal, the
    Python plane equals the native plane, K1 launched on both; the
    Python pass's host split (utils.trace pyplane.*) and a profiled
    native pass's device busy time and idle share (torch.profiler). The
    warm Python-plane pass's MultiSync.scan calls go into `record`, if
    given. Returns (the phase's record, the u8 capture)."""
    from profile_torch_prod import device_profile
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.phy.sync_vec import MultiSync
    from tetra_tpu_torch.utils import trace
    t0 = time.perf_counter()
    bits = P.mixed_bits(P.MIXER_CARRIERS, 0.1, fx)[0][fxm["mixer_rows"]]
    u8 = P.mixer_capture(bits, fxm["mixer_bins"])
    build_s = time.perf_counter() - t0
    offsets = fxm["mixer_offsets"]
    carriers = ",".join(repr(float(o)) for o in offsets)
    rec = P.mixer_record(fxm)
    n = len(u8) // 2
    stream_s = n / P.MIXER_FS
    res = {"carriers": len(offsets), "fs": P.MIXER_FS, "samples": n,
           "stream_s": stream_s, "capture_build_s": build_s, "card": card}
    got = {}
    for plane in ("python", "native"):
        calls = [] if record is None or plane != "python" else record
        with recording(MultiSync, "scan", calls):
            _, warm, _ = mixer_cli(u8, P.MIXER_FS, carriers, ks_path, plane,
                                   dev)
        logs = {c: [] for c in P.MIXER_LOG_CHANNELS}
        log = ([P.line_logger(logs[c]) if c in logs else (lambda *a: None)
                for c in range(len(offsets))] if plane == "python" else None)
        trace.clear_timings()
        reset_launches()
        mrx, wall, cmds = mixer_cli(u8, P.MIXER_FS, carriers, ks_path, plane,
                                    dev, log=log)
        n_launch = launches()
        split = {k.split(".", 1)[1] + "_s": v["total_s"]
                 for k, v in trace.timings().items()
                 if k.startswith("pyplane.")}
        got[plane] = [((c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong),
                       (c.mcc, c.mnc, c.colour_code)) for c in mrx.carriers]
        differ = [c for c, g in enumerate(got[plane])
                  if g != rec["mixer"][c]]
        res[plane] = {
            "warm_s": warm, "wall_s": wall,
            "realtime_carriers": len(offsets) * stream_s / wall,
            "mixer_front_end": mrx.pfb_channels is None,
            "crc_ok": sum(g[0][1] for g in got[plane]),
            "crc_wrong": sum(g[0][2] for g in got[plane]),
            "bursts": sum(g[0][0] for g in got[plane]),
            "carriers_differing_from_jax": differ,
            "rate_command": dict(cmds).get(2), "launches": n_launch}
        if plane == "python":
            res[plane]["log_digests_equal_jax"] = {
                c: P.digest(logs[c]) == d
                for c, d in rec["mixer_logs"].items()}
            res[plane]["log_lines"] = {c: len(v) for c, v in logs.items()}
            res[plane]["host_split"] = {
                **split, "other_s": wall - sum(split.values())}
    res["python_equals_native"] = got["python"] == got["native"]
    # device busy time and idle share of one more native pass
    prof = device_profile(lambda: mixer_cli(u8, P.MIXER_FS, carriers,
                                            ks_path, "native", dev), card)
    res["native_profile"] = {**prof, "top_kernels": prof["top_kernels"][:8]}
    res["split"] = mixer_split(dev, u8, offsets, P.MIXER_FS)
    res["split"]["share_of_python_pass"] = \
        res["split"]["pass_ms_est"] / (1e3 * res["python"]["wall_s"])
    res["split"]["share_of_native_pass"] = \
        res["split"]["pass_ms_est"] / (1e3 * res["native"]["wall_s"])
    ok = (res["python_equals_native"]
          and all(not res[p]["carriers_differing_from_jax"]
                  and res[p]["mixer_front_end"]
                  and res[p]["launches"]["viterbi_assembled"] > 0
                  and res[p]["launches"]["sync_scan"] > 0
                  for p in ("python", "native"))
          and all(res["python"]["log_digests_equal_jax"].values()))
    if not ok:
        raise AssertionError(f"mixer: {res}")
    return res, u8


def check_scan(dev, fxm: dict, mixer_u8) -> dict:
    """The carrier scan and --carriers auto against the 400 kHz two-cell
    u8 capture of the JAX scan test: scan.scan(confirm=True) on the card
    and on the CPU, and the CLI's --rtltcp --carriers auto on both planes
    and both devices (the confirmed on-grid carriers go through the PFB:
    K2, K3), all equal to the JAX record and card equal to CPU; and
    detect_carriers on mixer-64: the JAX record's candidates, SNRs and
    raster channel powers to 0.1 dB."""
    import numpy as np
    import rtl_tcp_mock
    from tetra_tpu_torch import prod_fixture as P, scan
    from tetra_tpu_torch.io.sdr import RtlTcpSource
    rec = P.mixer_record(fxm)
    u8 = fxm["scan_u8"]
    fs = float(fxm["scan_fs"])
    iq = RtlTcpSource._to_complex(u8)
    want = sorted((o, k, cell, ok) for o, _, k, cell, ok in rec["scan"])
    res = {"scan": {}, "auto": {}}
    snr = {}
    for d in (dev, "cpu"):
        results, _ = scan.scan(iq, fs, confirm=True, device=d)
        snr[str(d)] = [r["snr_db"] for r in results]
        res["scan"][str(d)] = sorted(
            (r["offset_hz"], r["confirmed"],
             (r["mcc"], r["mnc"], r["colour_code"]), r["crc_ok"])
            for r in results)
    res["scan_equals_jax"] = all(v == want for v in res["scan"].values())
    res["scan_snr_db"] = snr[str(dev)]
    res["scan_snr_max_diff_jax"] = max(
        abs(a - r[1]) for a, r in zip(snr[str(dev)], rec["scan"]))
    payload = rtl_tcp_mock.scan_payload(u8, fs)
    want_auto = sorted(rec["auto"])
    for d in (dev, "cpu"):
        for plane in ("python", "native"):
            if d is dev:
                reset_launches()
            mrx, _, _ = mixer_cli(payload, fs, "auto", None, plane, d,
                                  n=len(u8) // 2)
            got = sorted(((c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong),
                          (c.mcc, c.mnc, c.colour_code))
                         for c in mrx.carriers)
            res["auto"][f"{d}_{plane}"] = {
                "carriers": got, "pfb": mrx.pfb_channels is not None,
                "equals_jax": got == want_auto,
                **({"launches": launches()} if d is dev else {})}
    off, dsnr, (_, power, _) = scan.detect_carriers(
        RtlTcpSource._to_complex(mixer_u8), P.MIXER_FS, device=dev)
    j_off, j_snr, j_power = rec["detect"]
    res["mixer64_detect"] = {
        "candidates": len(off), "jax_candidates": len(j_off),
        "offsets_equal": bool(np.array_equal(off, j_off)),
        "snr_max_diff_db": float(np.abs(dsnr - j_snr).max()) if len(off)
        else 0.0,
        "power_max_diff_db": float(np.abs(power - j_power).max()),
        "channels": len(power)}
    det = res["mixer64_detect"]
    ok = (res["scan_equals_jax"] and res["scan_snr_max_diff_jax"] <= 0.1
          and all(v["equals_jax"] and v["pfb"] for v in res["auto"].values())
          and all(res["auto"][f"{dev}_{p}"]["launches"][k] > 0
                  for p in ("python", "native")
                  for k in ("viterbi_assembled", "pfb_wola", "resample_rows"))
          and det["offsets_equal"] and det["snr_max_diff_db"] <= 0.1
          and det["power_max_diff_db"] <= 0.1)
    if not ok:
        raise AssertionError(f"scan: {res}")
    return res


def python_run(packed, n_car: int, ks_path: str, dev, method: str,
               n_chunks: int, log_carriers=None, sink: bool = True):
    """One pass of MultiCarrierReceiver(control_plane="python") over
    `packed` in n_chunks calls of `method`: (receiver, per-carrier log
    lines (for log_carriers; all by default), TL-SDU sink calls, wall
    seconds). The per-stage timers (utils.trace "pyplane.*") are reset
    first."""
    import numpy as np
    import torch
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    from tetra_tpu_torch.utils import trace
    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    keep = set(range(n_car) if log_carriers is None else log_carriers)
    logs = {c: [] for c in keep}
    calls = []
    k = 2 if method == "process_iq8" else 1
    cuts = np.linspace(0, len(packed) // k, n_chunks + 1).astype(int) * k
    trace.clear_timings()
    sync()
    t0 = time.perf_counter()
    mrx = MultiCarrierReceiver(
        [], fs=25_000.0 * n_car, pfb_channels=np.arange(n_car), n_chan=n_car,
        keystore_path=ks_path, control_plane="python", device=dev,
        log=[P.line_logger(logs[c]) if c in keep else (lambda *a: None)
             for c in range(n_car)],
        tl_sdu_sink=(lambda c, pd, pt, b: calls.append(
            (c, pd, pt, b.tobytes()))) if sink else None)
    for i in range(n_chunks):
        getattr(mrx, method)(packed[cuts[i]:cuts[i + 1]],
                             final=i == n_chunks - 1)
    sync()
    return mrx, logs, calls, time.perf_counter() - t0


def iq8_capture(bits):
    """Per-carrier bits [C, L] -> interleaved int8 wideband IQ (6-sigma
    backoff), carrier c on PFB channel c of C."""
    import numpy as np
    from tetra_tpu_torch.io.stream import quantize_iq
    from tetra_tpu_torch.phy.channelizer import synthesize_wideband_fft
    from tetra_tpu_torch.phy.dqpsk import modulate
    wide = synthesize_wideband_fft(modulate(bits, sps=2),
                                   np.arange(bits.shape[0]), bits.shape[0])
    sig = float(np.sqrt(np.mean(np.abs(wide) ** 2) / 2))
    qr, qi = quantize_iq(wide.real / (6 * sig), wide.imag / (6 * sig))
    return np.stack([qr, qi], 1).reshape(-1)


def check_python_small(ks_path: str, dev, fx: dict) -> dict:
    """The 8-carrier capture through control_plane="python" on the card
    and on the CPU, in process_iq4c and process_iq8 (2 chunks each):
    per-carrier log lines, stats and TL-SDU sink calls identical."""
    from tetra_tpu_torch import prod_fixture as P
    bits, _ = P.mixed_bits(8, 0.25, fx)
    res = {}
    for method, packed in (("process_iq4c", P.wideband_capture(bits)),
                           ("process_iq8", iq8_capture(bits))):
        outs = []
        for d in (dev, "cpu"):
            mrx, logs, calls, _ = python_run(packed, 8, ks_path, d, method, 2)
            st = [(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
                  for c in mrx.carriers]
            outs.append((logs, st, calls))
        res[method] = {"crc_ok": sum(s[1] for s in outs[0][1]),
                       "crc_wrong": sum(s[2] for s in outs[0][1]),
                       "log_lines": sum(len(v) for v in outs[0][0].values()),
                       "sink_calls": len(outs[0][2]),
                       "logs_equal": outs[0][0] == outs[1][0],
                       "stats_equal": outs[0][1] == outs[1][1],
                       "sink_calls_equal": outs[0][2] == outs[1][2]}
    if not all(r["logs_equal"] and r["stats_equal"] and r["sink_calls_equal"]
               and r["crc_ok"] > 0 and r["sink_calls"] > 0
               for r in res.values()):
        raise AssertionError(f"python_small: card and CPU differ: {res}")
    return res


def run_python_plane(ks_path: str, packed, fx: dict, native, dev,
                     card: str) -> dict:
    """prod-1024 (4 chunks, keystore, process_iq4c) through
    control_plane="python", one timed pass with the launch counts set to
    0 just before it: per-carrier (bursts, crc_ok, crc_wrong) equal to
    the native plane's pass of this run (`native`), the 8 recorded
    carriers' stats and log digests equal to the JAX Python plane's
    record (prod_fixture.python_record), and the host split of the pass
    (utils.trace's pyplane.* timers: device front end, MultiSync.scan,
    decode_slots_multi, the per-carrier walk)."""
    import numpy as np
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.utils import trace
    rec = P.python_record(fx)["channels"]
    reset_launches()
    mrx, logs, _, wall = python_run(packed, N_CAR, ks_path, dev,
                                    "process_iq4c", N_CHUNKS,
                                    log_carriers=rec, sink=False)
    n_launch = launches()
    split = {k.split(".", 1)[1] + "_s": v["total_s"]
             for k, v in trace.timings().items() if k.startswith("pyplane.")}
    mine = np.asarray([(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
                       for c in mrx.carriers])
    nat = np.asarray([(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
                      for c in native.carriers])
    differ = np.flatnonzero((mine != nat).any(1)).tolist()
    jax_py = {c: {"port": mine[c].tolist(), "jax_python": list(st),
                  "log_digest_equal": P.digest(logs[c]) == dg,
                  "log_lines": len(logs[c])}
              for c, (st, dg) in rec.items()}
    rt = N_CAR * int(fx["length"]) / P.BITRATE
    res = {"carriers": N_CAR, "chunks": N_CHUNKS, "wall_s": wall,
           "realtime_carriers": rt / wall, "card": card,
           "host_split": {**split, "other_s": wall - sum(split.values())},
           "crc_ok": int(mine[:, 1].sum()), "crc_err": int(mine[:, 2].sum()),
           "carriers_differing_from_native": differ,
           "per_carrier_jax_python": jax_py, "launches": n_launch}
    if differ:
        raise AssertionError(f"python_plane: per-carrier stats differ from "
                             f"the native plane's: {res}")
    if any(v["port"] != v["jax_python"] or not v["log_digest_equal"]
           for v in jax_py.values()):
        raise AssertionError(f"python_plane: differs from the JAX Python "
                             f"plane's record: {jax_py}")
    if min(n_launch[k] for k in ("viterbi_assembled", "pfb_wola",
                                 "resample_rows", "sync_scan")) <= 0:
        raise AssertionError(f"python_plane: a kernel was not launched: "
                             f"{n_launch}")
    return res


def voice_from_dump(block: bytes) -> bytes:
    """One 690-int16 dump block -> its .cod frame without a keystream,
    decoded on the CPU (the plain chain). A block whose second half is
    erasures (0) is an NDB slot's 216-bit row."""
    import numpy as np
    import torch
    from tetra_tpu_torch.rx import _dump_index, voice_frames
    v = np.frombuffer(block, np.int16)[_dump_index(432)[0]]
    row = (v[:432 if v[216] else 216] < 0).astype(np.int8)[None]
    return voice_frames(torch.as_tensor(row),
                        np.zeros((1, 274), np.uint8)).tobytes()


def traffic_diff(got: dict, want: dict) -> dict:
    """One carrier's dump files against the fixture's: names, sizes and
    .txt must be equal; returns the .out slots with differing words
    ({usage_tsn: slots}), the count of differing words, and the .cod
    frames that are wrong. A voice frame may differ only in a slot whose
    .out block differs, and there it must be the CPU plain chain's
    decode of the card's own .out block, XOR the keystream the
    fixture's frame carries (fixture frame XOR the decode of the
    fixture's block; zero on a plain carrier)."""
    import numpy as np
    if {k: len(v) for k, v in got.items()} != \
            {k: len(v) for k, v in want.items()}:
        return {"structure": True}
    out_slots, words, bad_cod, cod_checked = {}, 0, [], 0
    for name in got:
        if name.endswith(".txt") and got[name] != want[name]:
            return {"structure": True}
        if name.endswith(".out") and got[name] != want[name]:
            d = (np.frombuffer(got[name], np.int16)
                 != np.frombuffer(want[name], np.int16)).reshape(-1, 690)
            out_slots[name[8:-4]] = set(np.flatnonzero(d.any(1)).tolist())
            words += int(d.sum())
    for name in got:
        if not name.endswith(".cod"):
            continue
        key, g, w = name[6:-4], got[name], want[name]
        out = f"traffic_{key}.out"
        for i in out_slots.get(key, ()):
            blk = slice(1380 * i, 1380 * (i + 1))
            fr = slice(35 * i, 35 * (i + 1))
            ks = bytes(a ^ b for a, b in
                       zip(w[fr], voice_from_dump(want[out][blk])))
            exp = bytes(a ^ b for a, b in
                        zip(voice_from_dump(got[out][blk]), ks))
            cod_checked += 1
            if g[fr] != exp:
                bad_cod.append((key, i))
        if g != w:
            d = (np.frombuffer(g, np.uint8)
                 != np.frombuffer(w, np.uint8)).reshape(-1, 35)
            bad_cod += [(key, i) for i in np.flatnonzero(d.any(1)).tolist()
                        if i not in out_slots.get(key, ())]
    return {"structure": False, "out_slots": out_slots, "words": words,
            "bad_cod": bad_cod, "cod_checked": cod_checked}


def run_voice(ks_path: str, packed, n_enc: int, fx: dict, dev, card: str,
              prod_wall: float) -> dict:
    """The 1024-carrier production capture, one timed pass with dumpdir
    and decode_voice (launch counts set to 0 just before it); every
    carrier's files against the fixture's expectation (the JAX bits
    path's files on the same rows). A carrier whose stats equal the
    bits path's must hold the same file names, sizes and .txt lines; its
    .out blocks may differ only in raw type-4 bits the wideband demod
    got wrong (traffic bits carry no CRC, so the stats cannot show
    them), at most RAW_BIT_LIMIT of the dumped bits; a voice frame may
    differ only in such a slot, and there it must be the CPU plain
    chain's decode of the card's own bits (traffic_diff)."""
    import tempfile
    import numpy as np
    from tetra_tpu_torch import prod_fixture
    from tetra_tpu_torch.umac.native_exec import EV
    want = prod_fixture.expected_traffic(fx)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        mrx, wall = prod_fixture.run_receiver(packed, N_CAR, ks_path, dev,
                                              N_CHUNKS, dumpdir=tmp,
                                              decode_voice=True)
        n_launch = launches()
        files = prod_fixture.read_tree(tmp)
    mine = np.asarray([(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
                       for c in mrx.carriers])
    as_bits = (mine == fx["jax_bits_stats"]).all(1)
    per = {c: {} for c in range(N_CAR)}
    for k, v in files.items():
        c, name = k.split("/", 1)
        per[int(c[len("carrier"):])][name] = v
    exact, raw, bad = 0, {}, []
    for c in np.flatnonzero(as_bits).tolist():
        exp = want["enc" if c >= N_CAR - n_enc else "plain"]
        if per[c] == exp:
            exact += 1
            continue
        d = traffic_diff(per[c], exp)
        if d["structure"] or d["bad_cod"]:
            bad.append(c)
        else:
            raw[c] = {"words": d["words"], "cod_checked": d["cod_checked"],
                      "slots": {k: sorted(v) for k, v in d["out_slots"].items()}}
    record = prod_fixture.wideband_record(fx)
    wide_files = {c: per[c] == f for c, (_, f) in record.items()}
    # K6's row count at each of its launches: per chunk, one voice decode
    # (n112 and n72) of the full frames and one of the NDB halves
    k6_groups = []
    for evd in mrx.native_events:
        tr = evd["kind"] == EV.TRAFFIC
        half = int((evd["b"][tr] == 1).sum())
        k6_groups += [r for r in (int(tr.sum()) - half, half) if r]
    n_slots = sum(len(v) // 1380 for k, v in files.items()
                  if k.endswith(".out"))
    raw_words = sum(r["words"] for r in raw.values())
    rt = N_CAR * int(fx["length"]) / prod_fixture.BITRATE
    res = {"carriers": N_CAR, "chunks": N_CHUNKS, "wall_s": wall,
           "realtime_carriers": rt / wall, "prod_wall_s": prod_wall,
           "prod_realtime_carriers": rt / prod_wall, "card": card,
           **counts(mrx), "traffic_slots_dumped": n_slots,
           "voice_frames": sum(len(v) // 35 for k, v in files.items()
                               if k.endswith(".cod")),
           "dump_bytes": sum(map(len, files.values())),
           "carriers_equal_jax_bits_path": int(as_bits.sum()),
           "carriers_differing_from_bits_path":
               np.flatnonzero(~as_bits).tolist(),
           "carriers_with_expected_files": exact,
           "carriers_with_raw_bit_differences": raw,
           "raw_bit_fraction": raw_words / max(n_slots * 432, 1),
           "carriers_bits_equal_files_differ": bad,
           "files_equal_jax_wideband": wide_files,
           "k6_rows_per_launch": k6_groups,
           "launches": n_launch}
    if bad or res["raw_bit_fraction"] > RAW_BIT_LIMIT \
            or not all(wide_files.values()):
        raise AssertionError(f"voice: files differ from the fixture: {res}")
    if n_launch["viterbi_decode"] <= 0 or res["voice_frames"] <= 0:
        raise AssertionError(f"voice: K6 not launched: {res}")
    if n_launch["viterbi_decode"] != 2 * len(k6_groups) \
            or sum(k6_groups) != res["traffic_slots"]:
        raise AssertionError(f"voice: K6's launches do not match the "
                             f"traffic slots: {res}")
    return res


def check_soft_small(dev) -> dict:
    """The snr8 capture at 8 carriers (fs = 200 kHz) through the soft
    receiver on the card and on the CPU: identical stats and events."""
    from tetra_tpu_torch import prod_fixture
    gpu, same_st, same_ev = card_vs_cpu(prod_fixture.snr8_capture(8), None,
                                        dev, "soft")
    res = {"carriers": 8, "stats_equal": same_st, "events_equal": same_ev,
           "crc_ok": sum(c.stats.crc_ok for c in gpu.carriers),
           "crc_err": sum(c.stats.crc_wrong for c in gpu.carriers)}
    if not (res["stats_equal"] and res["events_equal"]
            and res["crc_ok"] > 0):
        raise AssertionError(f"soft capture: card and CPU differ: {res}")
    return res


def run_snr8(dev, card: str, record: list | None = None) -> dict:
    """The 1024-carrier snr8 stage through the soft receiver: warm pass
    (its sync_scan calls recorded into `record`, if given), then a timed
    pass with the launch counts set to 0 just before it.
    The stats of the 16 carriers the fixture records must equal the JAX
    soft path's (prod_fixture.soft_record); the 5 carriers with the
    fewest CRC-OK blocks and the 5 with the most CRC errors are listed
    (the record's carriers were chosen from these lists)."""
    import numpy as np
    from tetra_tpu_torch import fastpath, prod_fixture
    t0 = time.perf_counter()
    fx = prod_fixture.load_snr8()
    packed = prod_fixture.snr8_capture(N_CAR, fx)
    T_bits = len(fx["row"])
    build_s = time.perf_counter() - t0
    with recording(fastpath, "sync_scan", [] if record is None else record):
        _, warm_s = prod_fixture.run_receiver(packed, N_CAR, None, dev,
                                              N_CHUNKS, "soft")
    reset_launches()
    mrx, wall = prod_fixture.run_receiver(packed, N_CAR, None, dev,
                                          N_CHUNKS, "soft")
    n_launch = launches()
    mine = np.asarray([(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
                       for c in mrx.carriers])
    crc_ok = int(mine[:, 1].sum())
    crc_err = int(mine[:, 2].sum())
    soft = {c: {"port": mine[c].tolist(), "jax_soft": list(st)}
            for c, st in prod_fixture.soft_record(fx).items()}
    worst = lambda col, sign: {
        int(c): mine[c].tolist()
        for c in np.argsort(sign * mine[:, col], kind="stable")[:5]}
    jax_rec = {"crc_ok": int(fx["snr8_crc_ok"]),
               "crc_err": int(fx["snr8_crc_err"]),
               "crc_ok_frac": round(int(fx["snr8_crc_ok"])
                                    / int(fx["clean_crc_ok"]), 4)}
    res = {"carriers": N_CAR, "chunks": N_CHUNKS,
           "snr_db": float(fx["snr_db"]),
           "bits_per_carrier": T_bits, "wideband_samples": int(len(packed)),
           "capture_build_s": build_s, "warm_s": warm_s, "wall_s": wall,
           "realtime_carriers": N_CAR * T_bits / prod_fixture.BITRATE / wall,
           "card": card, "crc_ok": crc_ok, "crc_err": crc_err,
           "crc_ok_frac": crc_ok / CLEAN_CRC_OK, "jax_record": jax_rec,
           "per_carrier_jax_soft": soft,
           "fewest_crc_ok": worst(1, 1), "most_crc_wrong": worst(2, -1),
           "launches": n_launch}
    if min(n_launch[k] for k in ("viterbi_assembled", "pfb_wola",
                                 "resample_rows", "viterbi_segmented",
                                 "sync_scan")) <= 0:
        raise AssertionError(f"a kernel was not launched: {n_launch}")
    if crc_ok < 0.90 * CLEAN_CRC_OK or crc_err > 2 * jax_rec["crc_err"]:
        raise AssertionError(f"snr8 decode outside its limits: {res}")
    if any(v["port"] != v["jax_soft"] for v in soft.values()):
        raise AssertionError(f"snr8: per-carrier stats differ from the JAX "
                             f"soft record: {soft}")
    return res


def k5_case(re, im, noisy) -> dict:
    """K5 (bits, phase pick, metric sums) vs its plain version on planes
    re, im [C, T] on the card; noisy [C] bool marks carriers with AWGN.
    Also the smallest gap between a carrier's two phase sums, relative to
    the larger (the margin of the closest phase pick)."""
    import torch
    from tetra_tpu_torch.phy import demod_fused
    got, best, met = demod_fused.demod_fused(re, im)
    want, best_p, met_p = demod_fused.demod_fused_plain(re, im)
    diff = got != want
    clean = ~noisy
    gap = (met_p[:, 0] - met_p[:, 1]).abs() / met_p.abs().amax(1).clamp(
        min=1e-30)
    res = {"carriers": int(re.shape[0]), "samples": int(re.shape[1]),
           "noisy_carriers": int(noisy.sum()),
           "mismatches_clean": int(diff[clean].sum()),
           "mismatch_frac_noisy": (float(diff[noisy].float().mean())
                                   if bool(noisy.any()) else 0.0),
           "phase_picks_differ": int((best != best_p).sum()),
           "metric_max_rel_err": float(((met - met_p).abs()
                                        / met_p.abs().clamp(min=1e-30))
                                       .max()),
           "min_phase_margin": float(gap.min()),
           "max_abs_err": int((got - want).abs().max()) if got.numel()
           else 0}
    if res["mismatches_clean"] or res["mismatch_frac_noisy"] > 1e-3 \
            or res["phase_picks_differ"] or res["metric_max_rel_err"] > 1e-4:
        raise AssertionError(f"K5 differs from its plain version: {res}")
    return res


def k5_small_planes(dev, C_: int, n_sym: int, seed: int, trim: int = 0,
                    delay: int = 0):
    """Clean random-bit planes [C_, 2 n_sym - trim] at sps 2 (delayed by
    `delay` samples) on dev, as the CPU tests make them."""
    import numpy as np
    import torch
    from tetra_tpu_torch.phy import dqpsk
    bits = np.random.default_rng(seed).integers(0, 2, (C_, 2 * n_sym))
    iq = dqpsk.modulate(bits.astype(np.uint8), sps=2)
    if delay:
        iq = np.concatenate([np.zeros((C_, delay), iq.dtype),
                             iq[:, :-delay]], 1)
    iq = iq[:, :iq.shape[1] - trim]
    return (torch.as_tensor(iq.real.astype(np.float32), device=dev),
            torch.as_tensor(iq.imag.astype(np.float32), device=dev))


# K5's other CPU-test shapes (tests/test_torch_steady.py): carriers,
# symbols, samples cut off the end, delay; T odd, T < 256, T not a
# multiple of the kernel's 2048-sample tile, one carrier
K5_SMALL = {"clean": (5, 700, 0, 0), "timing_offset": (4, 500, 0, 1),
            "single_block": (2, 64, 0, 0), "odd_T": (3, 301, 1, 0),
            "one_carrier": (1, 1500, 0, 1)}


def check_k5(dev, re, im, noisy) -> dict:
    """K5 on the noisy steady capture (noisy_steady), at the CPU tests'
    ragged [7, 602] and at the other K5_SMALL shapes (clean); times of
    the kernel (demodulate_hard_ri_pallas: one launch, nothing else on
    the card) and of the plain version at the steady shape."""
    import numpy as np
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch.phy import demod_fused, dqpsk
    res = {"steady": k5_case(re, im, noisy), "bound": k5_bound(re.numel())}
    res["ms"] = cuda_ms(lambda: demod_fused.demodulate_hard_ri_pallas(re, im))
    res["plain_ms"] = cuda_ms(lambda: dqpsk.demodulate_hard_ri(re, im),
                              reps=3)
    bits = np.random.default_rng(14).integers(0, 2, (7, 602))
    iq = dqpsk.modulate(bits.astype(np.uint8), sps=2)
    rr = torch.as_tensor(iq.real.astype(np.float32), device=dev)
    ri = torch.as_tensor(iq.imag.astype(np.float32), device=dev)
    res["ragged"] = k5_case(rr, ri, torch.zeros(7, dtype=torch.bool,
                                                device=dev))
    for seed, (name, (C_, n_sym, trim, delay)) in enumerate(K5_SMALL.items()):
        pr, pi = k5_small_planes(dev, C_, n_sym, 20 + seed, trim, delay)
        res[f"small_{name}"] = k5_case(pr, pi, torch.zeros(
            C_, dtype=torch.bool, device=dev))
    res["max_abs_err"] = max(v["max_abs_err"] for v in res.values()
                             if isinstance(v, dict) and "max_abs_err" in v)
    return res


def noisy_steady(dev):
    """The steady capture at 4096 carriers, the upper half with AWGN at
    8 dB from default_rng(5): (re, im [C, 32,768] f32, noisy [C] bool)
    on dev."""
    import torch
    from tetra_tpu_torch import steady_fixture
    half = STEADY_CAR // 2
    re_np, im_np = steady_fixture.capture(STEADY_CAR,
                                          noisy=range(half, STEADY_CAR),
                                          seed=5)
    re = torch.as_tensor(re_np, device=dev)
    im = torch.as_tensor(im_np, device=dev)
    return re, im, torch.arange(STEADY_CAR, device=dev) >= half


def check_k1_steady(re, im) -> dict:
    """K1 vs its plain version at the steady chain's shape: every K1
    call that locked_step_ri(fast="pallas") makes on the noisy steady
    capture (slots cut from K5's output), under decoders=("fused",)
    (n288) and the default three (SB1 n80, SB2 n144, SCH/F n288, NDB
    n144 x2), 262,144 rows each. A forward hook on every AssembledCode
    catches each call's inputs and outputs; bits and ok must equal the
    plain version's on the same inputs. Times K1 and the plain version
    on the first call of each n_sym, and holds K1 to the plain version
    on k1_edge_rows of that call's slots at each RAGGED row count."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    from tetra_tpu_torch.ops.viterbi_assembled import (AssembledCode,
                                                       decode_assembled_plain)
    calls = []

    def hook(mod, args, out):
        if isinstance(mod, AssembledCode):
            calls.append((name, mod, args, out))

    init = sf.load()["init"]
    inits = torch.full((re.shape[0],), init, dtype=torch.int64,
                       device=re.device)
    res = {"rows": re.shape[0] * sf.N_SLOTS, "calls": []}
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        for name, dec in (("fused", ("fused",)), ("all3", ALL3)):
            out = locked_step_ri(re, im, inits, phase_bit=sf.PHASE_BIT,
                                 n_slots=sf.N_SLOTS, fast="pallas",
                                 decoders=dec)
            res[f"crc_ok_{name}"] = int(out["crc_ok"].sum())
            del out
    finally:
        handle.remove()
    worst = max_abs = 0
    for name, mod, (x, tab, rm), (bk, ok_k) in calls:
        plain = lambda: decode_assembled_plain(x, mod.pidx, tab, rm,
                                               mod.n_sym, mod.boundaries,
                                               mod.crc_segs)
        bp, ok_p = plain()
        call = {"set": name, "n_sym": mod.n_sym, "rows": int(x.shape[0]),
                "cols": int(x.shape[1]),
                "mismatches": int((bk != bp).sum()),
                "ok_mismatches": int((ok_k != ok_p).sum()),
                "ok_flags": int(ok_k.sum())}
        worst = max(worst, call["mismatches"], call["ok_mismatches"],
                    int(x.shape[0] != res["rows"]))
        max_abs = max(max_abs, int((bk - bp).abs().max()),
                      int((ok_k - ok_p).abs().max()))
        key = f"n{mod.n_sym}"
        if f"ms_{key}" not in res:
            edge = k1_edge_mismatches(mod, x, tab)
            res[f"edge_mismatches_{key}"] = edge
            worst = max(worst, edge)
            n = int(x.shape[0])
            res[f"bound_{key}"] = bound(
                x.numel() + 4 * tab.numel() + rm.numel()
                + n * (mod.n_sym + len(mod.crc_segs)),
                viterbi_ops(n, mod.n_sym, 4) + n * mod.n_sym, INT32_OPS)
            res[f"ms_{key}"] = cuda_ms(lambda: mod(x, tab, rm))
            res[f"plain_ms_{key}"] = cuda_ms(plain, reps=1)
        res["calls"].append(call)
    del calls
    res["max_abs_err"] = max_abs
    n_syms = sorted({c["n_sym"] for c in res["calls"]})
    if worst or len(res["calls"]) != 6 or n_syms != [80, 144, 288]:
        raise AssertionError(f"K1 at the steady shape differs from its "
                             f"plain version: {res}")
    return res


def same_outputs(a: dict, b: dict) -> list:
    """Keys (or block fields) of two locked_step results that differ."""
    import torch
    bad = []
    if a.keys() != b.keys():
        return ["keys"]
    for k in a:
        if isinstance(a[k], tuple):
            bad += [f"{k}.{f}" for f, x, y in zip(a[k]._fields, a[k], b[k])
                    if not torch.equal(x.cpu(), y.cpu())]
        elif not torch.equal(a[k].cpu(), b[k].cpu()):
            bad.append(k)
    return bad


def check_steady_small(dev) -> dict:
    """8 carriers x 64 slots of the steady fixture (carriers 4..7 with
    AWGN at 8 dB) through locked_step_ri on the card and on the CPU."""
    import numpy as np
    import torch
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    fx = sf.load()
    re, im = sf.capture(8, noisy=range(4, 8), seed=6, fx=fx)
    inits = np.full(8, fx["init"])
    res = {"carriers": 8, "slots": sf.N_SLOTS}
    for name, fast, dec in (("pallas_fused", "pallas", ("fused",)),
                            ("pallas_all3", "pallas", ALL3),
                            ("soft", "soft", ("fused",))):
        outs = [locked_step_ri(torch.as_tensor(re, device=d),
                               torch.as_tensor(im, device=d), inits,
                               phase_bit=sf.PHASE_BIT, n_slots=sf.N_SLOTS,
                               fast=fast, decoders=dec)
                for d in (dev, torch.device("cpu"))]
        res[name] = {"crc_ok": int(outs[0]["crc_ok"].sum()),
                     "differs": same_outputs(*outs)}
        if res[name]["differs"] or res[name]["crc_ok"] == 0:
            raise AssertionError(f"steady_small: card and CPU differ: {res}")
    return res


def fixture_wrong(out: dict, fx: dict, idx, kinds, on=None) -> dict:
    """Slots of a locked_step result that differ from the steady fixture:
    kinds, CRC failures and each block's type-1 bits on the slots of its
    kind. idx [C, S] the fixture slot of each (carrier, slot), kinds
    [C, S] their kinds (tensors on the result's device); on [C, S] bool
    restricts the count to those slots."""
    import torch
    from tetra_tpu_torch import steady_fixture as sf
    dev = out["kinds"].device
    on = torch.ones_like(kinds, dtype=torch.bool) if on is None else on
    wrong = {"kinds": int(((out["kinds"] != kinds) & on).sum()),
             "crc_fail": int((~out["crc_ok"] & on).sum())}
    for key, (rkey, kind) in sf.BLOCKS.items():
        want = torch.as_tensor(fx[key], device=dev)[idx]
        ne = (out[rkey].type1 != want).any(-1) & on
        wrong[key] = int((ne & (kinds == kind)).sum() if kind is not None
                         else ne.sum())
    return wrong


def run_steady(dev, card: str) -> dict:
    """bench stage 3's shape: 4096 carriers x 64 slots of the clean
    steady fixture through locked_step_ri(fast="pallas") under both
    decoder sets; per set a warm pass, then a timed pass with the launch
    counts set to 0 just before it. The input planes are on the card
    before the clock starts; their host-to-card copy is timed apart."""
    import torch
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    t0 = time.perf_counter()
    fx = sf.load()
    re_np, im_np = sf.capture(STEADY_CAR, fx=fx)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    re = torch.as_tensor(re_np, device=dev)
    im = torch.as_tensor(im_np, device=dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    T = int(re.shape[1])
    del re_np, im_np
    idx = torch.as_tensor(sf.slot_index(STEADY_CAR), device=dev)
    kinds = torch.as_tensor(fx["kinds"], device=dev)[idx]
    inits = torch.full((STEADY_CAR,), fx["init"], dtype=torch.int64,
                       device=dev)
    res = {"carriers": STEADY_CAR, "slots": sf.N_SLOTS, "samples": T,
           "capture_build_s": build_s, "h2d_s": h2d_s,
           "h2d_bytes": 2 * 4 * STEADY_CAR * T, "card": card}
    for name, dec in (("fused", ("fused",)), ("all3", ALL3)):
        run = lambda: locked_step_ri(re, im, inits, phase_bit=sf.PHASE_BIT,
                                     n_slots=sf.N_SLOTS, fast="pallas",
                                     decoders=dec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = launches()
        wrong = fixture_wrong(out, fx, idx, kinds)
        res[name] = {"warm_s": warm, "wall_s": wall,
                     "realtime_carriers": STEADY_CAR * T / 36_000.0 / wall,
                     "crc_ok": int(out["crc_ok"].sum()), "wrong": wrong,
                     "launches": n_launch}
        if any(wrong.values()):
            raise AssertionError(f"steady {name}: decode differs from the "
                                 f"fixture: {res[name]}")
        if n_launch["demod_fused"] <= 0 or n_launch["viterbi_assembled"] <= 0:
            raise AssertionError(f"steady {name}: K5 or K1 not launched: "
                                 f"{n_launch}")
        del out
        torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


K5_SPS_SYM = 8192        # symbols a carrier in the K5 rate check
K5_LOCKED_SPS = (1, 4, 8)
K5_LOCKED_CAR = 512


def check_k5_sps(dev) -> dict:
    """K5 against its plain version at every rate it is built for: 64
    carriers x K5_SPS_SYM symbols of random bits modulated at sps 1..11
    (clean), and 7 carriers x 5,003 samples (T no multiple of the tile
    or of sps). Bits and phase picks identical, metric sums within 1e-5
    relative; the kernel's time, the plain version's and the bound at
    the first shape, and the launch shape."""
    import numpy as np
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import kernels
    from tetra_tpu_torch.phy import demod_fused, dqpsk
    res = {}
    for sps in demod_fused.SPS_RATES:
        bits = np.random.default_rng(100 + sps).integers(
            0, 2, (64, 2 * K5_SPS_SYM)).astype(np.uint8)
        iq = dqpsk.modulate(bits, sps=sps)
        re = torch.as_tensor(iq.real.astype(np.float32), device=dev)
        im = torch.as_tensor(iq.imag.astype(np.float32), device=dev)
        r = {"carriers": 64, "samples": int(re.shape[1]), "max_abs_err": 0}
        bad = 0
        for key, (a, b) in (("", (re, im)),
                            ("ragged_", (re[:7, :5003].contiguous(),
                                         im[:7, :5003].contiguous()))):
            got, best, met = demod_fused.demod_fused(a, b, sps)
            want, best_p, met_p = demod_fused.demod_fused_plain(a, b, sps)
            r[f"{key}mismatches"] = int((got != want).sum())
            r[f"{key}phase_picks_differ"] = int((best != best_p).sum())
            r[f"{key}metric_max_rel_err"] = float(
                ((met - met_p).abs() / met_p.abs().clamp(min=1e-30)).max())
            bad += r[f"{key}mismatches"] + r[f"{key}phase_picks_differ"] \
                + (r[f"{key}metric_max_rel_err"] > 1e-5)
            r["max_abs_err"] = max(r["max_abs_err"],
                                   int((got - want).abs().max()))
        r["ms"] = cuda_ms(lambda: demod_fused.demod_fused(re, im, sps))
        r["plain_ms"] = cuda_ms(
            lambda: demod_fused.demod_fused_plain(re, im, sps), reps=2)
        r.update(k5_bound(re.numel(), sps))
        r.update(kernels.occupancy("tt_demod_fused_sps", sps))
        res[f"sps{sps}"] = r
        if bad:
            raise AssertionError(f"K5 at sps {sps} differs from its plain "
                                 f"version: {r}")
    return res


def run_k5_locked(dev) -> dict:
    """locked_step_ri(fast="pallas", sps=s, decoders=("fused",)) for s in
    K5_LOCKED_SPS on K5_LOCKED_CAR carriers of the clean steady fixture
    modulated at that rate, one warm pass and one pass with the launch
    counts set to 0 just before it: every output of the first 64
    carriers (every fixture roll) equal to the CPU's plain chain on
    them, every later carrier's equal to its roll's (the planes repeat),
    K5 and K1 launched, and at sps 4 and 8 every kind, crc_ok and
    payload as the fixture says. At sps 1 the 11-tap RRC pair is not
    Nyquist at one sample a symbol (the transmit and matched filters
    alias), so a few slots of the clean capture fail in the JAX chain
    too (tests/test_torch_k5_rates.py); their count is printed."""
    import numpy as np
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    from tetra_tpu_torch.phy import demod_fused
    fx = sf.load()
    idx = torch.as_tensor(sf.slot_index(K5_LOCKED_CAR), device=dev)
    kinds = torch.as_tensor(fx["kinds"], device=dev)[idx]
    inits = np.full(K5_LOCKED_CAR, fx["init"])
    roll = torch.arange(K5_LOCKED_CAR, device=dev) % sf.N_SLOTS
    res = {}
    for sps in K5_LOCKED_SPS:
        re_np, im_np = sf.capture(K5_LOCKED_CAR, fx=fx, sps=sps)
        re = torch.as_tensor(re_np, device=dev)
        im = torch.as_tensor(im_np, device=dev)
        run = lambda a, b, i: locked_step_ri(
            a, b, i, phase_bit=sf.PHASE_BIT, n_slots=sf.N_SLOTS,
            fast="pallas", sps=sps, decoders=("fused",))
        run(re, im, inits)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = run(re, im, inits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = launches()
        head = {k: (type(v)(*(f[:sf.N_SLOTS] for f in v))
                    if isinstance(v, tuple) else v[:sf.N_SLOTS])
                for k, v in out.items()}
        cpu = run(torch.as_tensor(re_np[:sf.N_SLOTS]),
                  torch.as_tensor(im_np[:sf.N_SLOTS]), inits[:sf.N_SLOTS])
        rolled = {k: (type(v)(*(f[roll] for f in v))
                      if isinstance(v, tuple) else v[roll])
                  for k, v in out.items()}
        r = {"carriers": K5_LOCKED_CAR, "samples": int(re.shape[1]),
             "wall_s": wall, "k5_ms": cuda_ms(
                 lambda: demod_fused.demod_fused(re, im, sps)),
             "k5_bound": k5_bound(re.numel(), sps),
             "crc_ok": int(out["crc_ok"].sum()),
             "fixture_wrong": fixture_wrong(out, fx, idx, kinds),
             "card_cpu_differs": same_outputs(head, cpu),
             "rolls_differ": same_outputs(out, rolled),
             "launches": n_launch}
        res[f"sps{sps}"] = r
        if r["card_cpu_differs"] or r["rolls_differ"] \
                or (sps != 1 and any(r["fixture_wrong"].values())):
            raise AssertionError(f"k5_sps locked sps {sps}: {r}")
        if n_launch["demod_fused"] <= 0 or n_launch["viterbi_assembled"] <= 0:
            raise AssertionError(f"k5_sps locked sps {sps}: K5 or K1 not "
                                 f"launched: {r}")
        del re, im, out, head, cpu, rolled
    return res


TX_SOAK = 262_144        # SCH/F blocks of the tx phase's soak


def check_tx(dev) -> dict:
    """The transmitter on the card: the steady fixture's 64 slots
    rebuilt by the port's tx (steady_fixture.tx_slots) equal the stored
    ones; the self-test CLI in subprocesses on the card and with
    --device cpu prints the same lines and exits 0 with 0 CRC errors;
    TX_SOAK random SCH/F blocks and ACCESS-ASSIGN words from
    default_rng(17) encoded into bursts on the card (tx.make_schf_bursts)
    and decoded by decode_schf_burst (K1): every block CRC-OK and equal
    to its payload, and the card's bursts and decodes equal the CPU's
    on the first 1,024."""
    import numpy as np
    import torch
    from tetra_tpu_torch import steady_fixture as sf, tx
    from tetra_tpu_torch.lmac import pipeline
    from tetra_tpu_torch.ops.scramble import scramb_get_init
    root = pathlib.Path(__file__).resolve().parent
    fx = sf.load()
    t0 = time.perf_counter()
    slots, kinds, pay, init = sf.tx_slots(device=dev)
    res = {"steady_slots_equal": bool(
        np.array_equal(slots, fx["slots"]) and np.array_equal(kinds, fx["kinds"])
        and init == fx["init"]
        and all(np.array_equal(fx[k], v) for k, v in pay.items())),
        "steady_slots_s": time.perf_counter() - t0}
    outs = {}
    for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "tetra_tpu_torch.selftest",
                              *extra], cwd=root, capture_output=True,
                             text=True, timeout=600)
        outs[name] = (out.returncode, out.stdout, out.stderr,
                      time.perf_counter() - t0)
    lines = outs["card"][1].splitlines()
    res["selftest"] = {
        "rc": outs["card"][0], "cpu_rc": outs["cpu"][0],
        "stdout_equal": outs["card"][1] == outs["cpu"][1],
        "punct_ok_lines": sum(ln.startswith("==> Puncture/Depuncture")
                              and ln.endswith(": OK") for ln in lines),
        "last_line": lines[-1] if lines else "",
        "card_s": outs["card"][3], "cpu_s": outs["cpu"][3]}
    rng = np.random.default_rng(17)
    schf = torch.as_tensor(rng.integers(0, 2, (TX_SOAK, 268)).astype(np.int8))
    aach = torch.as_tensor(rng.integers(0, 2, (TX_SOAK, 14)).astype(np.int8))
    init = scramb_get_init(262, 42, 1)
    code = torch.tensor(init, dtype=torch.int64)

    def soak(d, n):
        b = tx.make_schf_bursts(schf[:n].to(d), aach[:n].to(d), init)
        return b, pipeline.decode_schf_burst(b, code.to(d))

    soak(dev, 1024)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    bursts, dec = soak(dev, TX_SOAK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = launches()
    ok = dec["SCH_F"].crc_ok
    exact = (dec["SCH_F"].type1.cpu() == schf).all(-1) \
        & (dec["BBK"].type1.cpu() == aach).all(-1)
    cb, cdec = soak(torch.device("cpu"), 1024)
    res["soak"] = {
        "blocks": TX_SOAK, "wall_s": wall, "crc_ok": int(ok.sum()),
        "payload_exact": int(exact.sum()),
        "card_equals_cpu_1024": bool(
            torch.equal(bursts[:1024].cpu(), cb)
            and all(torch.equal(a[:1024].cpu(), b) for k in cdec
                    for a, b in zip(dec[k], cdec[k]))),
        "launches": n_launch}
    sel = res["selftest"]
    if not (res["steady_slots_equal"] and sel["rc"] == 0
            and sel["cpu_rc"] == 0 and sel["stdout_equal"]
            and sel["punct_ok_lines"] == 9
            and sel["last_line"] == "total number of CRC Errors: 0"
            and res["soak"]["crc_ok"] == TX_SOAK
            and res["soak"]["payload_exact"] == TX_SOAK
            and res["soak"]["card_equals_cpu_1024"]
            and n_launch["viterbi_assembled"] > 0):
        raise AssertionError(f"tx: {res} {outs['card'][2][-2000:]}")
    return res


def eq_differs(a: dict, b: dict) -> dict:
    """Two fast="eq" results compared: 'all' the keys (or block fields)
    that differ anywhere (same_outputs); 'decoded' those that differ on
    the slots either result classifies (kind >= 0), kinds and crc_ok
    everywhere; 'undecoded_bit_frac' the share of differing bits on the
    other slots (NDB slots, which the equaliser's n and y pilots do not
    fit, so its near-tie picks fall either way)."""
    import torch
    on = (a["kinds"] >= 0).cpu() | (b["kinds"] >= 0).cpu()
    bad = []
    for k in a:
        for f, x, y in (zip(a[k]._fields, a[k], b[k]) if isinstance(a[k], tuple)
                        else [("", a[k], b[k])]):
            x, y = x.cpu(), y.cpu()
            if k not in ("kinds", "crc_ok"):
                x = x.reshape(*on.shape, -1)[on]
                y = y.reshape(*on.shape, -1)[on]
            if not torch.equal(x, y):
                bad.append(f"{k}.{f}" if f else k)
    ba = a["bits"].cpu().reshape(*on.shape, -1)[~on]
    bb = b["bits"].cpu().reshape(*on.shape, -1)[~on]
    return {"all": same_outputs(a, b), "decoded": bad,
            "undecoded_slots": int((~on).sum()),
            "undecoded_bit_frac": float((ba != bb).float().mean())
            if ba.numel() else 0.0}


def eq_run(re, im, inits, fast="eq"):
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    return locked_step_ri(re, im, inits, phase_bit=sf.PHASE_BIT,
                          n_slots=sf.N_SLOTS, fast=fast, decoders=("fused",))


def check_eq_small(dev) -> dict:
    """The 8-carrier degraded capture (steady_fixture.eq_capture(8): a
    carrier pair per channel group) through locked_step_ri(fast="eq") on
    the card and on the CPU: kinds and crc_ok identical everywhere, every
    output identical on the slots either classifies, and at most 1e-3 of
    the other slots' bits differing (eq_differs); whether every output
    is identical is printed."""
    import numpy as np
    import torch
    from tetra_tpu_torch import steady_fixture as sf
    fx = sf.load()
    re, im = sf.eq_capture(8, fx=fx)
    inits = np.full(8, fx["init"])
    outs = [eq_run(torch.as_tensor(re, device=d), torch.as_tensor(im, device=d),
                   inits) for d in (dev, torch.device("cpu"))]
    d = eq_differs(*outs)
    res = {"carriers": 8, "slots": sf.N_SLOTS,
           "crc_ok": int(outs[0]["crc_ok"].sum()),
           "identical": not d["all"], **d}
    if d["decoded"] or d["undecoded_bit_frac"] > 1e-3 or not res["crc_ok"]:
        raise AssertionError(f"eq_small: card and CPU differ: {res}")
    return res


def eq_split(re, im, inits, slots_ref) -> dict:
    """Device time (CUDA events, mean of 3 after a warm-up) of each
    layer of the equalised chain on the full planes: matched filter and
    slot cut, CFO estimates, pilot fits, decision-directed passes and the
    slicer, FEC (the fused decode); the composed stages must give the
    timed pass's bits."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.lmac.steady import locked_step_bits
    from tetra_tpu_torch.phy import equalize as eq
    zr, zi = eq._slot_planes(re, im, sf.N_SLOTS, sf.PHASE_BIT)
    cfo = eq._cfo(zr, zi)
    fits = eq._pilot_fits(*cfo)
    slots = eq._slice(*eq._equalise(*fits))
    ms = {"matched_filter": cuda_ms(lambda: eq._slot_planes(
              re, im, sf.N_SLOTS, sf.PHASE_BIT), 3),
          "cfo": cuda_ms(lambda: eq._cfo(zr, zi), 3),
          "pilot_fits": cuda_ms(lambda: eq._pilot_fits(*cfo), 3),
          "dd_passes": cuda_ms(lambda: eq._slice(*eq._equalise(*fits)), 3),
          "fec": cuda_ms(lambda: locked_step_bits(slots, inits,
                                                  decoders=("fused",)), 3)}
    same = torch.equal(slots.reshape(slots.shape[0], -1), slots_ref)
    del zr, zi, cfo, fits, slots
    if not same:
        raise AssertionError("eq split: the stages differ from the pass")
    return {"ms": ms, "sum_ms": sum(ms.values())}


def run_eq(dev, card: str) -> dict:
    """steady-eq-4096: the degraded capture eq_capture(4096) (each
    quarter of the carriers through one EQ_GROUPS channel), sps 2, phase
    bit 64, through locked_step_ri(fast="eq", decoders=("fused",)): a
    warm pass, then a timed pass with the launch counts set to 0. On the
    64 recorded carriers the per-slot kinds and crc_ok equal the JAX
    record (steady_fixture.eq_record) and the CPU's run of those
    carriers (eq_differs). At full width, per group, the CRC-OK share
    beside the record's (the record fails every NDB slot, whose p
    training the equaliser's pilots do not fit; the group passes when
    its share is at least the record's less three of the record's
    standard errors), and every CRC-OK slot's kind and payloads equal
    the fixture. Then fast="pallas" on the same planes, the layer split
    (eq_split), and fast=False on the clean capture (every slot equal
    to the fixture)."""
    import numpy as np
    import torch
    from tetra_tpu_torch import steady_fixture as sf
    fx = sf.load()
    rec = sf.eq_record()
    t0 = time.perf_counter()
    re_np, im_np = sf.eq_capture(rec["n_car"], seed=rec["seed"], fx=fx)
    build_s = time.perf_counter() - t0
    n_car, T = re_np.shape
    re = torch.as_tensor(re_np, device=dev)
    im = torch.as_tensor(im_np, device=dev)
    inits = torch.full((n_car,), fx["init"], dtype=torch.int64, device=dev)
    idx = torch.as_tensor(sf.slot_index(n_car), device=dev)
    kinds = torch.as_tensor(fx["kinds"], device=dev)[idx]
    rt = lambda w: n_car * T / 36_000.0 / w
    groups = torch.as_tensor(sf.eq_group(n_car), device=dev)
    res = {"carriers": n_car, "slots": sf.N_SLOTS, "samples": T,
           "capture_build_s": build_s, "card": card}
    for fast in ("eq", "pallas"):
        eq_run(re, im, inits, fast)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = eq_run(re, im, inits, fast)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res[fast] = {"wall_s": wall, "realtime_carriers": rt(wall),
                     "crc_ok": int(out["crc_ok"].sum()),
                     "crc_ok_by_group": {
                         name: int(out["crc_ok"][groups == g].sum())
                         for g, name in enumerate(sf.EQ_GROUPS)},
                     "launches": launches()}
        if fast == "eq":
            eq_out = out
        del out
    out = eq_out
    car = torch.as_tensor(rec["carriers"], device=dev)
    cpu = eq_run(torch.as_tensor(re_np[rec["carriers"]]),
                 torch.as_tensor(im_np[rec["carriers"]]),
                 np.full(len(car), fx["init"]))
    sub = {k: (type(v)(*(f[car] for f in v)) if isinstance(v, tuple)
               else v[car]) for k, v in out.items()}
    d = eq_differs(sub, cpu)
    res["recorded"] = {
        "carriers": len(car),
        "kinds_equal_record": bool(np.array_equal(
            sub["kinds"].cpu().numpy(), rec["kinds"])),
        "crc_ok_equal_record": bool(np.array_equal(
            sub["crc_ok"].cpu().numpy(), rec["crc_ok"])),
        "card_cpu_identical": not d["all"],
        "card_cpu_decoded_differs": d["decoded"],
        "card_cpu_undecoded_bit_frac": d["undecoded_bit_frac"]}
    del cpu, sub
    rec_groups = sf.eq_group(rec["n_car"], rec["carriers"])
    ok = out["crc_ok"]
    res["groups"] = {}
    group_pass = True
    for g, name in enumerate(sf.EQ_GROUPS):
        on = (groups == g)[:, None].expand_as(ok)
        share = float(ok[on].float().mean())
        r_ok = rec["crc_ok"][rec_groups == g]
        r_share = float(r_ok.mean())
        se = math.sqrt(r_share * (1 - r_share) / r_ok.size)
        non_ndb = on & (kinds != 2)
        res["groups"][name] = {
            "crc_ok_share": share, "record_share": r_share,
            "record_slots": int(r_ok.size), "pass_at": r_share - 3 * se,
            "non_ndb_crc_fail": int((~ok & non_ndb).sum()),
            "ndb_crc_ok": int((ok & on & (kinds == 2)).sum())}
        group_pass &= share >= r_share - 3 * se
    res["decoded_wrong"] = fixture_wrong(out, fx, idx, kinds, on=ok)
    res["split"] = eq_split(re, im, inits, out["bits"])
    del out, eq_out, re, im
    torch.cuda.empty_cache()
    rc_np, ic_np = sf.capture(n_car, fx=fx)
    rc = torch.as_tensor(rc_np, device=dev)
    ic = torch.as_tensor(ic_np, device=dev)
    del rc_np, ic_np
    eq_run(rc, ic, inits, False)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = eq_run(rc, ic, inits, False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["angle"] = {"wall_s": wall, "realtime_carriers": rt(wall),
                    "crc_ok": int(out["crc_ok"].sum()),
                    "wrong": fixture_wrong(out, fx, idx, kinds),
                    "launches": launches()}
    del out, rc, ic
    torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r = res["recorded"]
    if not (r["kinds_equal_record"] and r["crc_ok_equal_record"]
            and not r["card_cpu_decoded_differs"]
            and r["card_cpu_undecoded_bit_frac"] <= 1e-3 and group_pass
            and not any(res["decoded_wrong"].values())
            and not any(res["angle"]["wrong"].values())
            and res["eq"]["launches"]["viterbi_assembled"] > 0):
        raise AssertionError(f"eq: {res}")
    return res


WIDE_CHAN = 512                   # bench stage 5: 512 PFB channels
WIDE_FS = WIDE_CHAN * 25_000.0    # 12.8 MS/s
WIDE_SIGNAL = (3, 64, 129, 200, 255, 256, 383, 510)   # the signal check's
WIDE_PHASE_BIT = 64               # slot grid after the PFB (group delay
                                  # compensated: the 36 kHz input's own)


def wide_samples(n_slots: int) -> int:
    """Wideband samples of bench stage 5's input at n_slots
    (bench.py:201-205)."""
    need = 64 + n_slots * 510 + 64
    m_chan = int(need * 50_000.0 / 36_000.0) + 80
    return (m_chan + 2 * 16) * (WIDE_CHAN // 2)


def wide_step(wre, wim, inits, n_slots: int, phase_bit: int = 64):
    """Bench stage 5's composition: the 512-channel PFB to the demod
    rate (K2 + K3) feeding locked_step_ri(fast="pallas",
    decoders=("fused",)) (K5 + K1) on every channel."""
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    from tetra_tpu_torch.phy.pfb import pfb_to_demod_rate_ri
    cr, ci = pfb_to_demod_rate_ri(wre, wim, None, WIDE_CHAN, WIDE_FS)
    return locked_step_ri(cr, ci, inits, phase_bit=phase_bit,
                          n_slots=n_slots, fast="pallas", decoders=("fused",))


def run_wide512(dev, card: str) -> dict:
    """wide-512 (bench stage 5): Gaussian noise at the bench's shapes
    (n_slots 8 and 168, default_rng(1), bench.py:201-210) through
    wide_step, median of 5 timed runs each: the stage's samples per
    second as bench.py:213-218 computes them, the launches of one
    n_slots-168 step (counts set to 0 just before it), the card's kinds
    and crc_ok at n_slots 8 equal to the CPU plain chain's, and
    pfb_channelize_ri against K2's rows (transposed) on the n_slots-8
    input within 1e-4 of the peak. Then the signal check: the steady
    fixture's carriers on the WIDE_SIGNAL channels, synthesised at
    12.8 MS/s (synthesize_wideband_fft), through wide_step at n_slots 64
    and phase bit WIDE_PHASE_BIT: every slot of those channels equals
    the fixture."""
    import numpy as np
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.phy import channelizer as ch, dqpsk
    from tetra_tpu_torch.phy.pfb import (PfbFrontEnd, pfb_channelize_ri,
                                         pfb_channelize_rows)
    fx = sf.load()
    inits = torch.full((WIDE_CHAN,), fx["init"], dtype=torch.int64,
                       device=dev)
    rng = np.random.default_rng(1)
    res = {"channels": WIDE_CHAN, "fs": WIDE_FS, "card": card}
    times, planes = {}, {}
    for n_slots in (8, 168):
        T = wide_samples(n_slots)
        wre = rng.normal(0, 1, T).astype(np.float32)
        wim = rng.normal(0, 1, T).astype(np.float32)
        planes[n_slots] = (wre, wim)
        a = torch.as_tensor(wre, device=dev)
        b = torch.as_tensor(wim, device=dev)
        wide_step(a, b, inits, n_slots)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            if n_slots == 168 and not ts:
                reset_launches()
            t0 = time.perf_counter()
            out = wide_step(a, b, inits, n_slots)
            int(out["crc_ok"].sum())
            ts.append(time.perf_counter() - t0)
            if n_slots == 168 and len(ts) == 1:
                res["launches"] = launches()
        times[n_slots] = (float(np.median(ts)), T)
        if n_slots == 8:
            cpu = wide_step(torch.as_tensor(wre), torch.as_tensor(wim),
                            inits.cpu(), n_slots)
            res["card_equals_cpu_n8"] = bool(
                torch.equal(out["kinds"].cpu(), cpu["kinds"])
                and torch.equal(out["crc_ok"].cpu(), cpu["crc_ok"]))
            res["kinds_classified_n8"] = int((out["kinds"] >= 0).sum())
            fe = PfbFrontEnd(WIDE_CHAN, WIDE_FS).to(dev)
            yr, yi = pfb_channelize_rows(a, b, fe.h, fe.twc, fe.tws,
                                         WIDE_CHAN, fe.J)
            xr, xi = pfb_channelize_ri(a, b, WIDE_CHAN)
            d, scale = rel_err((yr.T, yi.T), (xr, xi))
            res["pfb_ri_vs_k2"] = {
                "frames": int(yr.shape[0]), "max_abs_err": d,
                "rel_to_peak": d / scale,
                "ri_ms": cuda_ms(lambda: pfb_channelize_ri(a, b, WIDE_CHAN),
                                 3),
                "k2_ms": cuda_ms(lambda: pfb_channelize_rows(
                    a, b, fe.h, fe.twc, fe.tws, WIDE_CHAN, fe.J), 3)}
            del yr, yi, xr, xi, cpu
        del out, a, b
    d_wide = times[168][1] - times[8][1]
    sps_rate = d_wide / (times[168][0] - times[8][0])
    res.update({"median_s": {str(k): v[0] for k, v in times.items()},
                "samples": {str(k): v[1] for k, v in times.items()},
                "samples_per_s": sps_rate,
                "carriers_realtime": sps_rate / WIDE_FS * WIDE_CHAN})
    # signal check
    t0 = time.perf_counter()
    n_sig = len(WIDE_SIGNAL)
    base = dqpsk.modulate(sf.carrier_bits(n_sig, fx), sps=2)
    wide = ch.synthesize_wideband_fft(base, WIDE_SIGNAL, WIDE_CHAN)
    res["signal_build_s"] = time.perf_counter() - t0
    a = torch.as_tensor(wide.real.astype(np.float32), device=dev)
    b = torch.as_tensor(wide.imag.astype(np.float32), device=dev)
    out = wide_step(a, b, inits, sf.N_SLOTS, WIDE_PHASE_BIT)
    chans = torch.as_tensor(WIDE_SIGNAL, device=dev)
    sub = {k: (type(v)(*(f[chans] for f in v)) if isinstance(v, tuple)
               else v[chans]) for k, v in out.items()}
    idx = torch.as_tensor(sf.slot_index(n_sig), device=dev)
    kinds = torch.as_tensor(fx["kinds"], device=dev)[idx]
    others = torch.ones(WIDE_CHAN, dtype=torch.bool, device=dev)
    others[chans] = False
    res["signal"] = {"channels": list(WIDE_SIGNAL),
                     "phase_bit": WIDE_PHASE_BIT,
                     "wideband_samples": int(a.shape[0]),
                     "crc_ok": int(sub["crc_ok"].sum()),
                     "wrong": fixture_wrong(sub, fx, idx, kinds),
                     "crc_ok_other_channels":
                         int(out["crc_ok"][others].sum())}
    del out, sub, a, b
    if not (res["card_equals_cpu_n8"]
            and res["pfb_ri_vs_k2"]["rel_to_peak"] <= TOL
            and not any(res["signal"]["wrong"].values())
            and all(res["launches"][k] > 0 for k in (
                "pfb_wola", "resample_rows", "demod_fused",
                "viterbi_assembled"))):
        raise AssertionError(f"wide512: {res}")
    return res


MESH_RANKS = 4                    # ranks of the mesh phase, all on cuda:0
MESH_PFB_CHAN = 512               # the time-sharded PFB: wide512's channels
MESH_PFB_T = 1 << 23              # 8.4 M wideband samples, 2.1 M a rank
MESH_PFB_STRIDE = 16              # frames kept of each rank's PFB shard
ING_CAR, ING_SLOTS, ING_CHUNKS = 1024, 16, 6   # bench stage 6


def steady_cut_capture(n_car: int):
    """steady-4096's slots cut at bit 0 (no pad: the slot grid starts at
    sample 0, as tools/dist_worker.build_capture cuts it), sps 2:
    (re, im) [n_car, 64 x 510] float32; only the 64 distinct rolls are
    modulated."""
    import numpy as np
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.phy.dqpsk import modulate
    fx = sf.load()
    slots = fx["slots"][sf.slot_index(sf.N_SLOTS)].reshape(sf.N_SLOTS, -1)
    base = modulate(slots, sps=2)
    rows = np.arange(n_car) % sf.N_SLOTS
    return (np.ascontiguousarray(base.real.astype(np.float32)[rows]),
            np.ascontiguousarray(base.imag.astype(np.float32)[rows]))


def _mesh_check(dist, torch, fn):
    """(fn(), this rank's seconds, launches): the launch counts set to 0
    and the ranks lined up by a barrier just before fn, the clock
    stopped after a synchronize."""
    from tetra_tpu_torch import kernels
    kernels.reset_launches()
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernels.launches()


def mesh_rank(rank: int, world: int, dev, ks_path: str) -> dict:
    """One rank of the mesh phase (every rank on cuda:0, gloo): the
    prod-1024 bits through the native receiver on a carrier mesh, the
    soft fused chunk on the dry run's capture, sharded_locked_step on
    steady-4096, sharded_locked_step_2d on the cut capture (2 x 2), the
    time-sharded PFB, and the dry run's rank outputs; per check this
    rank's outputs, seconds and kernel launches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tetra_tpu_torch import prod_fixture, steady_fixture as sf
    from tetra_tpu_torch.parallel import dist_worker, dryrun, mesh as M
    from tetra_tpu_torch.parallel.launch import rank_env_check
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    from tetra_tpu_torch.umac.native_exec import EV
    rank_env_check()
    res = {}
    car = M.make_mesh(axis_name="car")

    # 1. prod-1024's bits, 4 chunks, each rank walking 256 carriers
    bits, _ = prod_fixture.mixed_bits(N_CAR, 0.1)
    cuts = np.linspace(0, bits.shape[1], N_CHUNKS + 1).astype(int)

    def prod_bits(sink):
        mc = MultiCarrierReceiver(
            np.zeros(N_CAR), fs=25_000.0 * N_CAR, control_plane="native",
            mesh=car, keystore_path=ks_path, device=dev,
            tl_sdu_sink=lambda *a: sink.append(dist_worker.sink_entry(*a)))
        for k in range(N_CHUNKS):
            mc.process_bits(bits[:, cuts[k]:cuts[k + 1]],
                            final=k == N_CHUNKS - 1)
        return mc

    _mesh_check(dist, torch, lambda: prod_bits([]))     # warm
    sink = []
    mc, wall, n_l = _mesh_check(dist, torch, lambda: prod_bits(sink))
    f = mc._fast
    kinds = np.concatenate([e["kind"] for e in mc.native_events])
    res["prod_bits"] = {
        "owned": [f.car0, f.car0 + f.n_local], "wall_s": wall,
        "launches": n_l, "sink": sink,
        "stats": np.asarray([(c.stats.bursts, c.stats.crc_ok,
                              c.stats.crc_wrong)
                             for c in mc.carriers[f.car0:f.car0 + f.n_local]]),
        "events": {k: int((kinds == getattr(EV, v)).sum())
                   for k, v in (("traffic_slots", "TRAFFIC"),
                                ("tl_sdus", "TLSDU"),
                                ("frag_ends", "FRAG_END"))}}
    del mc, bits

    # 2. the soft fused chunk on the dry run's capture (K4 on each rank)
    inp = dryrun.inputs(world, dev)
    dryrun.run_fast(inp, dev, car, soft=True)             # warm
    soft, wall, n_l = _mesh_check(
        dist, torch, lambda: dryrun.run_fast(inp, dev, car, soft=True))
    res["soft"] = {"outs": soft, "wall_s": wall, "launches": n_l}

    # 3. sharded_locked_step on steady-4096, 1024 carriers a rank
    mesh = M.make_mesh()
    fx = sf.load()
    re_g, im_g = sf.capture(STEADY_CAR, fx=fx)
    re = M.local_shard(re_g, mesh, ("carrier", None), dev)
    im = M.local_shard(im_g, mesh, ("carrier", None), dev)
    del re_g, im_g
    inits = torch.full((re.shape[0],), int(fx["init"]), dtype=torch.int64,
                       device=dev)
    step = M.sharded_locked_step(mesh, phase_bit=sf.PHASE_BIT,
                                 n_slots=sf.N_SLOTS)
    step(re, im, inits)                                   # warm
    out, wall, n_l = _mesh_check(dist, torch, lambda: step(re, im, inits))
    res["steady"] = {"coords": M.mesh_coords(mesh), "wall_s": wall,
                     "launches": n_l,
                     **{k: out[k].cpu().numpy()
                        for k in ("kinds", "crc_ok", "schf_type1",
                                  "crc_ok_total")}}
    del re, im, out

    # 4. sharded_locked_step_2d, 2 hosts x 2 chips: each host rank holds
    # only its own time window (32 slots) of its 2048 carriers
    mesh2 = M.make_mesh_2d(hosts=2)
    re_g, im_g = steady_cut_capture(STEADY_CAR)
    spec_t = ("chip", "host")
    re = M.local_shard(re_g, mesh2, spec_t, dev)
    im = M.local_shard(im_g, mesh2, spec_t, dev)
    del re_g, im_g
    inits = torch.full((re.shape[0],), int(fx["init"]), dtype=torch.int64,
                       device=dev)
    step2 = M.sharded_locked_step_2d(mesh2)
    step2(re, im, inits)                                  # warm
    out, wall, n_l = _mesh_check(dist, torch, lambda: step2(re, im, inits))
    res["steady_2d"] = {"coords": M.mesh_coords(mesh2), "wall_s": wall,
                        "launches": n_l, "window": list(re.shape),
                        **{k: out[k].cpu().numpy()
                           for k in ("kinds", "crc_ok", "schf_type1",
                                     "crc_ok_total")}}
    del re, im, out

    # the time-sharded PFB (plain pfb_channelize_ri, as the JAX package
    # calls XLA there), timed as the median of 5 steps after a warm-up
    tmesh = M.make_mesh(axis_name="time")
    rng = np.random.default_rng(7)
    wre = rng.standard_normal(MESH_PFB_T, dtype=np.float32)
    wim = rng.standard_normal(MESH_PFB_T, dtype=np.float32)
    xr = M.local_shard(wre, tmesh, ("time",), dev)
    xi = M.local_shard(wim, tmesh, ("time",), dev)
    chan = M.sharded_pfb_channelize(tmesh, MESH_PFB_CHAN)
    walls = []
    for _ in range(6):
        (cr, ci), t, _ = _mesh_check(dist, torch, lambda: chan(xr, xi))
        walls.append(t)
    res["pfb"] = {"coords": M.mesh_coords(tmesh), "ms": 1e3 * float(
        np.median(walls[1:])), "frames": int(cr.shape[-1]),
        "re": cr[:, ::MESH_PFB_STRIDE].cpu().numpy(),
        "im": ci[:, ::MESH_PFB_STRIDE].cpu().numpy()}
    del xr, xi, cr, ci

    # 5. the dry run's rank outputs
    res["dryrun"], wall, n_l = _mesh_check(
        dist, torch, lambda: dryrun.rank_outputs(rank, world, dev))
    res["dryrun_wall_s"] = wall
    rank_env_check()
    return res


def _stitched(outs, key, field, spec, sizes):
    from tetra_tpu_torch.parallel.mesh import stitch
    return stitch([(o[key]["coords"], o[key][field]) for o in outs], spec,
                  sizes)


def ingest_chunks(dev):
    """bench stage 6's inputs (bench.py:220-230, 260-263): 16 SCH/F
    bursts (seeded type-1 and AACH bits, the port's encoder) between 64
    zero bits, modulated at sps 2, tiled over ING_CAR carriers at 0.7
    of full scale, as int8 planes [2, C, T] and as 4+4-bit IQ [C, T];
    the cell scrambling code per carrier."""
    import numpy as np
    from tetra_tpu_torch import tx
    from tetra_tpu_torch.io import stream
    from tetra_tpu_torch.ops.scramble import scramb_get_init
    from tetra_tpu_torch.phy.dqpsk import modulate
    init = scramb_get_init(262, 42, 1)
    rng = np.random.default_rng(0)
    uniq = tx.make_schf_bursts(
        rng.integers(0, 2, (ING_SLOTS, 268)).astype(np.int8),
        rng.integers(0, 2, (ING_SLOTS, 14)).astype(np.int8), init, dev)
    pad = np.zeros(64, np.int8)
    bits = np.concatenate([pad, uniq.cpu().numpy().reshape(-1), pad])
    iq = modulate(bits[None], sps=2)[0]
    re = np.tile(iq.real, (ING_CAR, 1)) * 0.7
    im = np.tile(iq.imag, (ING_CAR, 1)) * 0.7
    return (np.stack(stream.quantize_iq(re, im)), stream.quantize_iq4(re, im),
            np.full(ING_CAR, init, np.uint32))


def check_stream_map(dev, card: str) -> dict:
    """bench stage 6 over stream_map: the iq8 and iq4 ingest steps
    (dequantize, locked_step_ri(fast="pallas", fused decode): K5 and K1)
    on ING_CHUNKS chunks of ING_CAR carriers, the CRC-OK count of each
    chunk equal to a plain loop's over the same chunks (upload, step,
    one after the other); samples per second of the median of 3 passes,
    a pass ending when the last count is on the host."""
    import numpy as np
    import torch
    from tetra_tpu_torch.io import stream
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    iq8, iq4, init = ingest_chunks(dev)

    def locked(init_d, re, im):
        return locked_step_ri(re, im, init_d, phase_bit=64,
                              n_slots=ING_SLOTS, fast="pallas",
                              decoders=("fused",))["crc_ok"].sum()

    steps = {"iq8": lambda i, c: locked(i, *stream.dequantize_iq(c[0], c[1])),
             "iq4": lambda i, c: locked(i, *stream.dequantize_iq4(c))}
    res = {"carriers": ING_CAR, "chunks": ING_CHUNKS, "card": card}
    for name, chunk in (("iq8", iq8), ("iq4", iq4)):
        step = steps[name]
        chunks = [chunk] * ING_CHUNKS
        init_d = torch.as_tensor(init.astype(np.int64), device=dev)
        plain = [int(step(init_d, torch.as_tensor(c, device=dev)))
                 for c in chunks]

        def run():
            outs = list(stream.stream_map(step, chunks, device=dev,
                                          static=init))
            return [int(o) for o in outs]

        got = run()
        reset_launches()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        n_l = launches()
        t = float(np.median(walls))
        samples = ING_CHUNKS * ING_CAR * chunk.shape[-1]
        res[name] = {"crc_ok": got, "plain_crc_ok": plain, "wall_s": t,
                     "samples_per_s": samples / t,
                     "carriers_realtime": samples / t / 36_000.0,
                     "launches": n_l}
        if got != plain or min(got) != ING_CAR * ING_SLOTS:
            raise AssertionError(f"stream_map {name}: {got} vs the plain "
                                 f"loop's {plain}")
        if n_l["demod_fused"] <= 0 or n_l["viterbi_assembled"] <= 0:
            raise AssertionError(f"stream_map {name}: K5 or K1 not "
                                 f"launched: {n_l}")
    return res


def run_mesh(ks_path: str, dev, card: str, fx: dict) -> dict:
    """The mesh phase: MESH_RANKS ranks on cuda:0 (launch.py, gloo) run
    mesh_rank; each check's outputs stitched here and held against the
    one-process run of the port on the card (and prod-1024's against the
    JAX bits path's record), then stream_map. Each check's wall_s is the
    slowest rank's."""
    import numpy as np
    import torch
    from tetra_tpu_torch import prod_fixture, steady_fixture as sf
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    from tetra_tpu_torch.parallel import dist_worker, dryrun
    from tetra_tpu_torch.parallel.launch import launch
    from tetra_tpu_torch.phy.pfb import pfb_channelize_ri
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    t0 = time.perf_counter()
    outs = launch(mesh_rank, MESH_RANKS, ks_path, device=dev.type,
                  timeout=900)
    res = {"ranks": MESH_RANKS, "device": str(dev), "card": card,
           "launch_s": time.perf_counter() - t0}
    wall = lambda key: max(o[key]["wall_s"] for o in outs)
    add = lambda key: {k: sum(o[key]["launches"][k] for o in outs)
                       for k in outs[0][key]["launches"]}

    # 1. prod-1024's bits: the union of the ranks' carriers against the
    # JAX bits path and the one-process native pass on the same bits
    bits, _ = prod_fixture.mixed_bits(N_CAR, 0.1, fx)
    cuts = np.linspace(0, bits.shape[1], N_CHUNKS + 1).astype(int)
    sink = []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    mc = MultiCarrierReceiver(
        np.zeros(N_CAR), fs=25_000.0 * N_CAR, control_plane="native",
        keystore_path=ks_path, device=dev,
        tl_sdu_sink=lambda *a: sink.append(dist_worker.sink_entry(*a)))
    for k in range(N_CHUNKS):
        mc.process_bits(bits[:, cuts[k]:cuts[k + 1]], final=k == N_CHUNKS - 1)
    sync()
    one_s = time.perf_counter() - t0
    one = np.asarray([(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
                      for c in mc.carriers])
    mesh_st = np.zeros_like(one)
    for o in outs:
        lo, hi = o["prod_bits"]["owned"]
        mesh_st[lo:hi] = o["prod_bits"]["stats"]
        if {e[0] for e in o["prod_bits"]["sink"]} - set(range(lo, hi)):
            raise AssertionError("a rank's TL-SDU sink holds another "
                                 "rank's carrier")
    by_car = lambda entries: {c: [e[1:] for e in entries if e[0] == c]
                              for c in range(N_CAR)}
    sink_mesh = by_car([e for o in outs for e in o["prod_bits"]["sink"]])
    events = {k: sum(o["prod_bits"]["events"][k] for o in outs)
              for k in outs[0]["prod_bits"]["events"]}
    want = {k: int(fx[f"ref_{k}"][1]) for k in events}
    prod = {"wall_s": wall("prod_bits"), "one_process_wall_s": one_s,
            "carriers_equal_jax_bits_path": int(
                (mesh_st == fx["jax_bits_stats"]).all(1).sum()),
            "carriers_equal_one_process": int((mesh_st == one).all(1).sum()),
            "crc_ok": int(mesh_st[:, 1].sum()),
            "crc_err": int(mesh_st[:, 2].sum()), **events,
            "jax_bits_path": want,
            "tl_sdus_equal_one_process": sink_mesh == by_car(sink),
            "launches": add("prod_bits")}
    res["prod_bits"] = prod
    if (prod["carriers_equal_jax_bits_path"] != N_CAR
            or prod["carriers_equal_one_process"] != N_CAR
            or not prod["tl_sdus_equal_one_process"] or events != want):
        raise AssertionError(f"mesh prod-1024 bits: {prod}")
    if min(prod["launches"][k] for k in ("viterbi_assembled",
                                         "sync_scan")) <= 0:
        raise AssertionError(f"mesh prod-1024 bits: a kernel was not "
                             f"launched: {prod['launches']}")
    del mc, sink, sink_mesh

    # 2. the soft fused chunk against the one-process run
    inp = dryrun.inputs(MESH_RANKS, dev)
    dryrun.run_fast(inp, dev, soft=True)                  # warm
    sync()
    t0 = time.perf_counter()
    ref_soft = dryrun.run_fast(inp, dev, soft=True)
    sync()
    one_s = time.perf_counter() - t0
    for o in outs:
        for a, b in zip(o["soft"]["outs"], ref_soft, strict=True):
            for k in dryrun.FAST_KEYS:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"mesh soft fast path: {k}")
    res["soft"] = {"wall_s": wall("soft"), "one_process_wall_s": one_s,
                   "chunks": len(ref_soft),
                   "crc_ok": sum(int(d["okA"].sum()) for d in ref_soft),
                   "launches": add("soft"),
                   "k4_launches_per_rank": [o["soft"]["launches"][
                       "viterbi_segmented"] for o in outs]}
    if min(res["soft"]["k4_launches_per_rank"]) <= 0:
        raise AssertionError("mesh soft fast path: K4 not launched on "
                             "every rank")

    # 3. and 4. the steady chains against the one-process chain
    fxs = sf.load()
    inits = torch.full((STEADY_CAR,), int(fxs["init"]), dtype=torch.int64,
                       device=dev)
    for key, planes, kw, spec, sizes in (
            ("steady", lambda: sf.capture(STEADY_CAR, fx=fxs),
             dict(phase_bit=sf.PHASE_BIT, n_slots=sf.N_SLOTS),
             ("carrier",), {"carrier": MESH_RANKS}),
            ("steady_2d", lambda: steady_cut_capture(STEADY_CAR),
             dict(phase_bit=0, n_slots=sf.N_SLOTS, decoders=("fused",)),
             ("chip", "host"), {"host": 2, "chip": MESH_RANKS // 2})):
        re_np, im_np = planes()
        re = torch.as_tensor(re_np, device=dev)
        im = torch.as_tensor(im_np, device=dev)
        del re_np, im_np
        locked_step_ri(re, im, inits, **kw)                 # warm
        sync()
        t0 = time.perf_counter()
        ref = locked_step_ri(re, im, inits, **kw)
        sync()
        one_s = time.perf_counter() - t0
        diff = {}
        for f in ("kinds", "crc_ok", "schf_type1"):
            want_f = (ref["schf"].type1 if f == "schf_type1" else ref[f])
            got_f = _stitched(outs, key, f, spec, sizes)
            diff[f] = int((got_f != want_f.cpu().numpy()).sum())
        totals = {int(o[key]["crc_ok_total"]) for o in outs}
        res[key] = {"wall_s": wall(key), "one_process_wall_s": one_s,
                    "mismatches": diff,
                    "crc_ok_total": sorted(totals),
                    "launches": add(key),
                    "rank_window": outs[0][key].get("window")}
        if any(diff.values()) or totals != {STEADY_CAR * sf.N_SLOTS}:
            raise AssertionError(f"mesh {key}: {res[key]}")
        if res[key]["launches"]["viterbi_assembled"] <= 0:
            raise AssertionError(f"mesh {key}: K1 not launched")
        del re, im, ref

    # the time-sharded PFB against the one-process channelizer
    rng = np.random.default_rng(7)
    wre = torch.as_tensor(rng.standard_normal(MESH_PFB_T, dtype=np.float32),
                          device=dev)
    wim = torch.as_tensor(rng.standard_normal(MESH_PFB_T, dtype=np.float32),
                          device=dev)
    from profile_torch_demod import cuda_ms
    one_ms = cuda_ms(lambda: pfb_channelize_ri(wre, wim, MESH_PFB_CHAN),
                     reps=5)
    cr, ci = pfb_channelize_ri(wre, wim, MESH_PFB_CHAN)
    n_valid = cr.shape[-1] - (16 * MESH_PFB_CHAN) // (MESH_PFB_CHAN // 2) - 1
    err, scale = 0.0, 0.0
    for i, ref in enumerate((cr, ci)):
        got = _stitched(outs, "pfb", ("re", "im")[i], (None, "time"),
                        {"time": MESH_RANKS})
        keep = np.arange(0, outs[0]["pfb"]["frames"] * MESH_RANKS,
                         MESH_PFB_STRIDE)
        on = keep < n_valid
        want_np = ref.cpu().numpy()[:, keep[on]]
        err = max(err, float(np.abs(got[:, on] - want_np).max()))
        scale = max(scale, float(np.abs(want_np).max()))
    res["pfb"] = {"channels": MESH_PFB_CHAN, "samples": MESH_PFB_T,
                  "sharded_ms": max(o["pfb"]["ms"] for o in outs),
                  "one_process_ms": one_ms, "max_abs_err": err,
                  "peak": scale}
    if err > TOL * scale:
        raise AssertionError(f"mesh PFB: {res['pfb']}")
    del wre, wim, cr, ci

    # 5. the dry run
    inp = dryrun.inputs(MESH_RANKS, dev)
    counts = dryrun.check([o["dryrun"] for o in outs],
                          dryrun.unsharded(inp, dev), inp)
    res["dryrun"] = {"wall_s": max(o["dryrun_wall_s"] for o in outs),
                     **counts,
                     "launches": {k: sum(o["dryrun"]["launches"][k]
                                         for o in outs)
                                  for k in outs[0]["dryrun"]["launches"]}}

    # 6. stream_map
    t0 = time.perf_counter()
    res["stream_map"] = check_stream_map(dev, card)
    res["stream_map"]["wall_s"] = time.perf_counter() - t0
    return res


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    try:
        from tetra_tpu_torch import fastpath, kernels, prod_fixture
        from tetra_tpu_torch.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: the tetra_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    try:
        dev = resolve_device("cuda")
        card = smi()
        t0 = time.perf_counter()
        kernels.build()
        kernels.lib()
        emit({"phase": "device", "nvidia_smi": card,
              "kind": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": time.perf_counter() - t0})

        k1 = check_k1(dev, 20_000)
        emit({"phase": "kernels", "kernel": "K1", **k1})
        k4 = check_k4(dev, K4_ROWS)
        emit({"phase": "kernels", "kernel": "K4", **k4})
        # main-path shapes: one wideband chunk of the 1024-carrier capture
        # plus its overlap-save history; CPU-test shapes: C = 8
        k23 = check_pfb(dev, N_CAR, 6_672_000, 1)
        emit({"phase": "kernels", "kernel": "K2+K3", **k23})
        # wide-512's n_slots-168 step (run_wide512's input length), then
        # ragged channel counts (K2's direct DFT at 12 and 1000)
        k23w = check_pfb(dev, WIDE_CHAN, wide_samples(168), 4)
        emit({"phase": "kernels", "kernel": "K2+K3 (wide-512)", **k23w})
        for n_chan, T, seed in ((8, 60_000, 2), (12, 30_000, 3),
                                (1000, 400_000, 5)):
            emit({"phase": "kernels", "kernel": "K2+K3",
                  **check_pfb(dev, n_chan, T, seed)})

        with prod_fixture.keystore_file() as ks_path:
            emit({"phase": "small", **check_small(ks_path, dev)})
            emit({"phase": "voice_small",
                  **check_voice_small(ks_path, dev)})
            fx = prod_fixture.load()
            emit({"phase": "rx_small", **check_rx_small(ks_path, dev, fx)})
            emit({"phase": "cli", **check_cli(ks_path, fx)})
            emit({"phase": "python_small",
                  **check_python_small(ks_path, dev, fx)})
            fxm = prod_fixture.load_mixer()
            emit({"phase": "mixer_small", **check_mixer_small(dev, fxm)})
            mixer_calls = []
            mixer, mixer_u8 = run_mixer(ks_path, dev, fx, fxm, card,
                                        mixer_calls)
            emit({"phase": "mixer", **mixer})
            emit({"phase": "scan", **check_scan(dev, fxm, mixer_u8)})
            del mixer_u8

            t0 = time.perf_counter()
            bits, n_enc = prod_fixture.mixed_bits(N_CAR, 0.1, fx)
            packed = prod_fixture.wideband_capture(bits)
            T_bits = bits.shape[1]
            emit({"phase": "prod_fixture", "carriers": N_CAR,
                  "encrypted": n_enc, "bits_per_carrier": T_bits,
                  "wideband_samples": int(len(packed)),
                  "build_s": time.perf_counter() - t0})
            prod_calls = []
            with recording(fastpath, "sync_scan", prod_calls):
                _, warm_s = prod_fixture.run_receiver(packed, N_CAR, ks_path,
                                                      dev, N_CHUNKS)
            reset_launches()
            mrx, wall = prod_fixture.run_receiver(packed, N_CAR, ks_path,
                                                  dev, N_CHUNKS)
            n_launch = launches()
            voice = run_voice(ks_path, packed, n_enc, fx, dev, card, wall)
            pyplane = run_python_plane(ks_path, packed, fx, mrx, dev, card)
        got = counts(mrx)
        ref = {k: [int(v) for v in fx[f"ref_{k}"]] for k in got}
        in_window = {k: ref[k][0] <= got[k] <= ref[k][1] for k in got}
        # the window's low ends are the JAX wideband path's counts
        equals_jax_wideband = all(got[k] == ref[k][0] for k in got)
        # per carrier against the JAX bits path on the same rows
        mine = np.asarray([(c.stats.bursts, c.stats.crc_ok,
                            c.stats.crc_wrong) for c in mrx.carriers])
        jbits = fx["jax_bits_stats"]
        per_carrier = {
            "carriers_equal_jax_bits_path": int((mine == jbits).all(1).sum()),
            "crc_ok_short_of_bits_path": int((jbits[:, 1] - mine[:, 1]).sum()),
            "carriers_with_crc_wrong": int((mine[:, 2] > 0).sum())}
        # the JAX wideband path's own per-carrier record on 8 carriers
        wide = {c: {"port": mine[c].tolist(), "jax_wideband": list(st)}
                for c, (st, _) in prod_fixture.wideband_record(fx).items()}
        rt = N_CAR * T_bits / prod_fixture.BITRATE / wall
        emit({"phase": "prod", "carriers": N_CAR, "chunks": N_CHUNKS,
              "encrypted": n_enc, "warm_s": warm_s, "wall_s": wall,
              "realtime_carriers": rt, "card": card, **got,
              "jax_window": ref, "in_window": in_window,
              "equals_jax_wideband": equals_jax_wideband, **per_carrier,
              "per_carrier_jax_wideband": wide, "launches": n_launch})
        if not all(in_window.values()):
            raise AssertionError("decode counts outside the JAX window")
        if any(v["port"] != v["jax_wideband"] for v in wide.values()):
            raise AssertionError("per-carrier stats differ from the JAX "
                                 "wideband record")
        if min(n_launch[k] for k in ("viterbi_assembled", "pfb_wola",
                                     "resample_rows", "sync_scan")) <= 0:
            raise AssertionError(f"a kernel was not launched: {n_launch}")
        emit({"phase": "voice", **voice})
        emit({"phase": "python_plane", **pyplane})
        p_launch = pyplane["launches"]
        k6 = check_k6(dev, voice["k6_rows_per_launch"])
        emit({"phase": "kernels", "kernel": "K6", **k6})

        emit({"phase": "soft_small", **check_soft_small(dev)})
        snr8_calls = []
        snr8 = run_snr8(dev, card, snr8_calls)
        emit({"phase": "snr8", **snr8})
        s_launch = snr8["launches"]
        s1 = check_sync(dev, prod_calls, snr8_calls, mixer_calls)
        s1["launches_per_pass"] = {"prod": n_launch["sync_scan"],
                                   "snr8": s_launch["sync_scan"]}
        emit({"phase": "kernels", "kernel": "S1", **s1})
        del prod_calls, snr8_calls, mixer_calls

        from profile_torch_demod import stage_times
        re, im, noisy = noisy_steady(dev)
        k5 = check_k5(dev, re, im, noisy)
        emit({"phase": "kernels", "kernel": "K5", **k5})
        k1s = check_k1_steady(re, im)
        emit({"phase": "kernels", "kernel": "K1 (steady)", **k1s})
        del re, im, noisy
        torch.cuda.empty_cache()
        k7 = stage_times(dev)
        emit({"phase": "kernels", "kernel": "K7", **k7})
        emit({"phase": "steady_small", **check_steady_small(dev)})
        steady = run_steady(dev, card)
        emit({"phase": "steady", **steady})
        d_launch = steady["fused"]["launches"]

        k5r = check_k5_sps(dev)
        emit({"phase": "kernels", "kernel": "K5 (every rate)", **k5r})
        k5l = run_k5_locked(dev)
        emit({"phase": "k5_sps", **k5l})
        tx_res = check_tx(dev)
        emit({"phase": "tx", **tx_res})
        emit({"phase": "eq_small", **check_eq_small(dev)})
        eq = run_eq(dev, card)
        emit({"phase": "eq", **eq})
        wide = run_wide512(dev, card)
        emit({"phase": "wide512", **wide})
        with prod_fixture.keystore_file() as ks_path:
            mesh = run_mesh(ks_path, dev, card, fx)
        emit({"phase": "mesh", **mesh})
        # launch shape at the main path's calls: fused K1 (K 512, three
        # maps, n288) and the soft path's K4 (N 4, n288)
        k1_occ = kernels.occupancy("tt_viterbi_assembled", 512, 3, 288)
        k4_occ = kernels.occupancy("tt_viterbi_segmented", 4, 288)
        k2_occ = kernels.occupancy("tt_pfb_wola", N_CAR)
        # K3 at the plan of every front end (L 25, M 18, NT 8, width 31):
        # channel-major on the main path, time-major for the record
        k3_occ = kernels.occupancy("tt_resample_rows", 25, 18, 8, 31, 1)
        k3_occ_rows = kernels.occupancy("tt_resample_rows", 25, 18, 8, 31,
                                        0)
        k5_occ = kernels.occupancy("tt_demod_fused_sps", 2)
        k6_occ = kernels.occupancy("tt_viterbi_decode", 3, 112)
        s1_occ = kernels.occupancy("tt_sync_scan")
        emit({"phase": "occupancy", "K1": k1_occ, "K4": k4_occ,
              "K2": k2_occ, "K3": k3_occ, "K3_time_major": k3_occ_rows,
              "K5": k5_occ, "K6": k6_occ, "S1": s1_occ,
              "K5_rates": {k: {f: v[f] for f in ("blocks_per_sm",
                                                 "regs_per_thread",
                                                 "smem_per_block")}
                           for k, v in k5r.items()}})
        # K5 at each rate: launches on the path that runs that rate (the
        # steady chain at sps 2, k5_sps's locked chains at 1, 4 and 8; no
        # path runs the other rates)
        rate_launch = {2: d_launch["demod_fused"],
                       **{s_: k5l[f"sps{s_}"]["launches"]["demod_fused"]
                          for s_ in K5_LOCKED_SPS}}
        k5_rates = [
            {"name": f"demod_fused (sps {s_})", "route": "cuda",
             "source": "tetra_tpu_torch/csrc/demod_fused.cu",
             "replaces": "tetra_tpu/phy/demod_pallas.py:165",
             "launches": rate_launch.get(s_, 0),
             "path": ("steady" if s_ == 2 else "k5_sps locked_step_ri"
                      if s_ in K5_LOCKED_SPS else None),
             "carriers": r["carriers"], "samples": r["samples"],
             "max_abs_err": float(r["max_abs_err"]), "ms": r["ms"],
             "plain_ms": r["plain_ms"],
             **{k: r[k] for k in ("bound_ms", "bound_by", "bound_bytes",
                                  "bound_ops", "bound_peak")},
             "library_ms": None}
            for s_, r in ((int(k[3:]), v) for k, v in k5r.items())]
        k6_main = f"n112_{max(k6['voice_rows'])}"

        emit({"kernels": [
            {"name": "viterbi_assembled", "route": "cuda",
             "source": "tetra_tpu_torch/csrc/viterbi_assembled.cu",
             "replaces": "tetra_tpu/ops/viterbi_pallas.py:631",
             "launches": n_launch["viterbi_assembled"],
             "python_plane_launches": p_launch["viterbi_assembled"],
             "mixer_launches": mixer["python"]["launches"][
                 "viterbi_assembled"],
             "mixer_native_launches": mixer["native"]["launches"][
                 "viterbi_assembled"],
             "max_abs_err": float(max(k1["max_abs_err"],
                                      k1s["max_abs_err"])),
             "ms": k1["ms_n288"], "plain_ms": k1["plain_ms_n288"],
             "ms_n80": k1["ms_n80"], "plain_ms_n80": k1["plain_ms_n80"],
             "ms_n144": k1["ms_n144"],
             "plain_ms_n144": k1["plain_ms_n144"],
             "steady_launches": d_launch["viterbi_assembled"],
             "eq_launches": eq["eq"]["launches"]["viterbi_assembled"],
             "angle_launches": eq["angle"]["launches"]["viterbi_assembled"],
             "wide512_launches": wide["launches"]["viterbi_assembled"],
             "tx_launches": tx_res["soak"]["launches"]["viterbi_assembled"],
             "mesh_launches": mesh["prod_bits"]["launches"][
                 "viterbi_assembled"],
             "mesh_steady_launches": mesh["steady"]["launches"][
                 "viterbi_assembled"],
             "mesh_steady_2d_launches": mesh["steady_2d"]["launches"][
                 "viterbi_assembled"],
             "stream_map_launches": mesh["stream_map"]["iq8"]["launches"][
                 "viterbi_assembled"],
             **{f"steady_{k}": k1s[k] for k in k1s
                if k.startswith(("ms_", "plain_ms_"))},
             **k1["bound_n288"], "library_ms": None, **k1_occ},
            {"name": "pfb_wola", "route": "cuda",
             "source": "tetra_tpu_torch/csrc/pfb_wola.cu",
             "replaces": "tetra_tpu/phy/pfb_pallas.py:212",
             "launches": n_launch["pfb_wola"],
             "python_plane_launches": p_launch["pfb_wola"],
             "wide512_launches": wide["launches"]["pfb_wola"],
             "max_abs_err": k23["k2_max_abs_err"],
             "ms": k23["k2_ms"], "plain_ms": k23["k2_plain_ms"],
             "dft_only_ms": k23["k2_dft_only_ms"],
             **k23["k2_bound"], "library_ms": None, **k2_occ},
            {"name": "resample_rows", "route": "cuda",
             "source": "tetra_tpu_torch/csrc/resample_rows.cu",
             "replaces": "tetra_tpu/phy/pfb_pallas.py:337",
             "launches": n_launch["resample_rows"],
             "python_plane_launches": p_launch["resample_rows"],
             "snr8_launches": s_launch["resample_rows"],
             "wide512_launches": wide["launches"]["resample_rows"],
             "max_abs_err": max(k23["k3_max_abs_err"],
                                k23w["k3_max_abs_err"]),
             "ms": k23["k3_ms"], "plain_ms": k23["k3_plain_ms"],
             "share_of_bound": k23["k3_share_of_bound"],
             "ms_time_major": k23["k3"]["rows"]["ms"],
             "ms_subset": k23["k3"]["subset"]["ms"],
             "layout_copy_ms": k23["k3"]["layout_copy_ms"],
             "wide512_ms": k23w["k3_ms"],
             "wide512_share_of_bound": k23w["k3_share_of_bound"],
             "wide512_library_ms": k23w["k3_library_ms"],
             **k23["k3_bound"], "library_ms": k23["k3_library_ms"],
             "library_call": "torch.nn.functional.conv2d", **k3_occ},
            {"name": "viterbi_segmented", "route": "cuda",
             "source": "tetra_tpu_torch/csrc/viterbi_segmented.cu",
             "replaces": "tetra_tpu/ops/viterbi_pallas.py:967",
             "launches": s_launch["viterbi_segmented"],
             "mesh_launches": mesh["soft"]["launches"]["viterbi_segmented"],
             "max_abs_err": float(k4["max_abs_err"]),
             "ms": k4["ms_n288"], "plain_ms": k4["plain_ms_n288"],
             "ms_n80": k4["ms_n80"], "plain_ms_n80": k4["plain_ms_n80"],
             **k4["bound_n288"], "library_ms": None, **k4_occ},
            {"name": "viterbi_decode", "route": "cuda",
             "source": "tetra_tpu_torch/csrc/viterbi_segmented.cu",
             "replaces": "tetra_tpu/ops/viterbi_pallas.py:1019",
             "launches": voice["launches"]["viterbi_decode"],
             "max_abs_err": float(k6["max_abs_err"]),
             "ms": k6[f"ms_{k6_main}"], "plain_ms": k6[f"plain_ms_{k6_main}"],
             **{k: k6[k] for k in k6
                if k.startswith(("ms_", "plain_ms_", "device_ms_"))},
             "empty_launch_ms": k6["empty_launch_ms"],
             **k6[f"bound_{k6_main}"], "library_ms": None, **k6_occ},
            {"name": "demod_fused", "route": "cuda",
             "source": "tetra_tpu_torch/csrc/demod_fused.cu",
             "replaces": "tetra_tpu/phy/demod_pallas.py:165",
             "launches": d_launch["demod_fused"],
             "wide512_launches": wide["launches"]["demod_fused"],
             "stream_map_launches": mesh["stream_map"]["iq8"]["launches"][
                 "demod_fused"],
             "max_abs_err": float(k5["max_abs_err"]),
             "ms": k5["ms"], "plain_ms": k5["plain_ms"],
             **k5["bound"], "library_ms": None, **k5_occ},
            {"name": "demod_fused (K7 stage bisect, kernel alone)",
             "route": "cuda",
             "source": "tetra_tpu_torch/csrc/demod_fused.cu",
             "replaces": "tools/profile_demod_stages.py:93",
             "launches": d_launch["demod_fused"],
             "max_abs_err": float(k7["max_abs_err"]),
             "ms": k7["ms"]["4096"]["kernel"],
             "plain_ms": k7["ms"]["4096"]["plain"],
             **k5["bound"], "library_ms": None}, *k5_rates,
            {"name": "sync_scan", "route": "cuda",
             "source": "tetra_tpu_torch/csrc/sync_scan.cu",
             "replaces": "tetra_tpu/phy/sync_vec.py:215 (lax.scan, not a "
                         "Pallas kernel)",
             "launches": n_launch["sync_scan"],
             "snr8_launches": s_launch["sync_scan"],
             "python_plane_launches": p_launch["sync_scan"],
             "mixer_launches": mixer["python"]["launches"]["sync_scan"],
             "mixer_native_launches": mixer["native"]["launches"][
                 "sync_scan"],
             "mesh_launches": mesh["prod_bits"]["launches"]["sync_scan"],
             "launches_per_call": s1["prod"]["launches_per_call"],
             "steps": s1["prod"]["steps"],
             "max_abs_err": s1["max_abs_err"],
             "ms": s1["prod"]["ms"], "plain_ms": s1["prod"]["plain_ms"],
             "maps_ms": s1["prod"]["maps_ms"],
             "steps_kernel_ms": s1["prod"]["steps_kernel_ms"],
             "snr8_ms": s1["snr8"]["ms"],
             "snr8_plain_ms": s1["snr8"]["plain_ms"],
             **{k: s1["prod"][k] for k in ("bound_ms", "bound_by",
                                           "bound_bytes", "bound_ops",
                                           "bound_peak")},
             "share_of_bound": s1["prod"]["bound_ms"] / s1["prod"]["ms"],
             "snr8_bound_ms": s1["snr8"]["bound_ms"],
             "snr8_bound_by": s1["snr8"]["bound_by"],
             "library_ms": None, "library_reason": s1["library_reason"],
             **s1_occ}]})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
