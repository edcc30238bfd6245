"""Write the capture fixtures of the PyTorch port:
tetra_tpu_torch/data/prod_mixed.npz (production capture),
tetra_tpu_torch/data/snr8_clean.npz (the noisy soft-mode capture) and
tetra_tpu_torch/data/steady_mixed.npz (the steady locked-step chain).

The file holds the two padded 16-frame rows of bench_mc_e2e.mixed_batch
(plain and TEA1-encrypted, before the per-carrier roll, bit-packed), the
noise-window length n_tail the rolls are confined to, and the decode
counts the JAX package recorded for the 1024-carrier production stage
(bench.py stage 11 -> bench_mc_e2e.run_prod): the wideband path's and
the pre-demodulated bits path's counts on the same bits, stored as a
[low, high] window per key. It also stores the JAX bits path's
per-carrier (bursts, crc_ok, crc_wrong) on the 1024 rolled rows,
computed here in batches of 128 carriers (carriers are independent
receivers on that path); their totals must equal the recorded bits-path
counts. And it stores the traffic outputs of the JAX bits path with
dumpdir and decode_voice=True on the first (plain) and the last
(TEA1-encrypted) of the 1024 rolled rows: every file name and its
bytes, per row type. The rolls keep each carrier's slots inside its
stream, so every plain carrier writes the plain row's files and every
encrypted carrier the encrypted row's. `parity` adds, in place, the JAX
wideband path's per-carrier stats and dump files on 8 carriers of the
1024-carrier capture (wideband_parity); run it after `prod`, which
rewrites the file without them. `pyplane` adds, in place, the JAX
Python control plane's record (python_plane_record): tetra_tpu's
TetraReceiver on one carrier of the 8-carrier capture, and its
MultiCarrierReceiver(control_plane="python") on the 8 parity carriers of
the 1024-carrier capture; run it after `prod` too.

snr8_clean.npz holds the padded clean 16-frame SYNC/SCH_F row of
bench_mc_e2e.run_snr8 (bit-packed), its n_tail, the SNR, and the JAX
package's record of that stage at 1024 carriers (BENCH_r05.json:
mc_e2e_snr8_crc_ok / _crc_err, and the clean capture's
mc_e2e_wideband_crc_ok). `snr8parity` adds, in place, the JAX soft
path's per-carrier stats on 16 carriers of the 1024-carrier snr8
capture (soft_parity); run it after `snr8`, which rewrites the file
without them.

steady_mixed.npz holds the 64 slots of the steady locked-step fixture
(tests/test_steady.py's _mixed_slots recipe on one grid: slot s has kind
s % 3 = SYNC, SCH/F, NDB, each with its own payload), bit-packed, the
scrambling code, and each slot's expected kind and type-1 payloads; the
64 slots with 64 zero bits at each end make one 32,768-bit carrier.

eq_degraded.npz (`eq`, after `steady`) holds the JAX fast="eq" chain's
per-slot kinds and CRC flags on the 64 recorded carriers
(steady_fixture.EQ_RECORD, 16 per channel group) of the 4096-carrier
degraded capture (steady_fixture.eq_capture, rebuilt from its numpy
seeds, so JAX and the port see the same planes), with the channel table
and the seed.

Runs on the CPU with jax (the rows come from tetra_tpu's TX chain);
the argument picks one file (default: all):

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py [prod|parity|pyplane|snr8|snr8parity|steady|mixer|eq]

mixer_offgrid.npz (`mixer`, after `prod`, whose rows it uses) holds the
mixer-bank records of mixer_record: the off-grid full-width
configuration mixer-64 (its bins and offsets; the capture is rebuilt,
not stored), the two-cell 144 kHz capture's bits and the 400 kHz scan
capture, each with the JAX package's result.
"""
import contextlib
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("TETRA_TPU_TESTS", "1")   # no persistent jax cache

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np

import bench_mc_e2e as B

N_FRAMES = 16
# The 1024-carrier production stage as recorded by the JAX package
# (BENCH_r05.json: mc_e2e_prod_* on the wideband path, mc_e2e_mixed_*
# on the pre-demodulated bits of the same capture): decode counts only.
REF_WINDOW = {
    "crc_ok": (79_862, 79_872),
    "crc_err": (0, 0),
    "traffic_slots": (12_287, 12_288),
    "tl_sdus": (36_859, 36_864),
    "frag_ends": (4_094, 4_096),
    "n_encrypted": (102, 102),
}


@contextlib.contextmanager
def jax_short_row_dumps():
    """tetra_tpu.rx.TetraReceiver._dump_traffic raises ValueError on an
    NDB slot's 216-bit traffic row: its four spans assume 432 bits.
    While this is active such a row is dumped as tetra_tpu_torch.rx
    dumps it: the bits it has as -127/127, the positions it lacks 0
    (erasure), the SSI line, and its voice frames from the JAX package's
    own _decode_voice_slot (which decodes the missing positions as
    erasures), with the usage, timeslot and SSI defaults of the Python
    plane's call. Rows of 432 bits take the unchanged JAX code."""
    from tetra_tpu.rx import TetraReceiver
    orig = TetraReceiver._dump_traffic

    def dump(self, type4, usage=None, tsn=None, ssi=None, voice_ks=None):
        if len(type4) >= 432 or not self.dumpdir:
            return orig(self, type4, usage, tsn, ssi, voice_ks)
        # the Python plane's defaults (tetra_tpu.rx._dump_traffic)
        if usage is None:
            usage = self.umac.cur_burst_is_traffic
        if tsn is None:
            tsn = self.time.tn - 1
        if ssi is None:
            ssi = self.umac.ssi
        block = np.zeros(690, dtype=np.int16)
        for i in range(6):
            block[115 * i] = 0x6B21 + i
        for dst, src, n in ((1, 0, 114), (116, 114, 114), (231, 228, 114),
                            (346, 342, 90)):
            seg = np.asarray(type4[src:src + n])
            block[dst:dst + len(seg)] = np.where(seg != 0, -127, 127)
        base = os.path.join(self.dumpdir, f"traffic_{usage}_{tsn}")
        with open(base + ".out", "ab") as f:
            f.write(block.tobytes())
        with open(base + ".txt", "a") as f:
            f.write(f"{ssi}\n")
        if self.decode_voice:
            self._decode_voice_slot(type4, usage, tsn, voice_ks)

    TetraReceiver._dump_traffic = dump
    try:
        yield
    finally:
        TetraReceiver._dump_traffic = orig


def rows(seed: int = 0):
    """The padded plain / encrypted rows and n_tail, exactly as
    bench_mc_e2e.mixed_batch builds them before the roll."""
    rng = np.random.default_rng(seed)
    plain = B.make_mixed_stream(rng, N_FRAMES, encrypted=False)
    enc = B.make_mixed_stream(np.random.default_rng(seed + 1), N_FRAMES,
                              encrypted=True)
    L = B.common_len(N_FRAMES)
    n_tail = L - len(plain)
    plain = B.circular_safe_pad(plain, rng, L - len(plain))
    enc = B.circular_safe_pad(enc, np.random.default_rng(seed + 2),
                              L - len(enc))
    return plain.astype(np.uint8), enc.astype(np.uint8), n_tail


def bits_path_stats(bits, batch: int = 128):
    """The JAX package's pre-demodulated bits path (native plane, 4
    chunks, as bench_mc_e2e.run_mixed) over `bits` [n, L] in carrier
    batches: per-carrier [n, 3] (bursts, crc_ok, crc_wrong) and the
    event totals."""
    import tempfile
    from tetra_tpu.rx_multi import MultiCarrierReceiver
    from tetra_tpu.umac.native_exec import EV
    n_car, T = bits.shape
    cuts = np.linspace(0, T, 5).astype(int)
    stats = np.zeros((n_car, 3), np.int32)
    tot = {"traffic_slots": 0, "tl_sdus": 0, "frag_ends": 0}
    with tempfile.TemporaryDirectory() as tmp:
        ks = pathlib.Path(tmp) / "keys.txt"
        ks.write_text(B.KEYSTORE)
        for lo in range(0, n_car, batch):
            sub = bits[lo:lo + batch]
            mc = MultiCarrierReceiver(np.zeros(len(sub)),
                                      fs=25_000.0 * len(sub),
                                      control_plane="native",
                                      keystore_path=str(ks))
            for k in range(4):
                st = mc.process_bits(sub[:, cuts[k]:cuts[k + 1]],
                                     final=k == 3)
            stats[lo:lo + len(sub)] = [(s.bursts, s.crc_ok, s.crc_wrong)
                                       for s in st]
            kinds = np.concatenate([e["kind"] for e in mc.native_events])
            tot["traffic_slots"] += int((kinds == EV.TRAFFIC).sum())
            tot["tl_sdus"] += int((kinds == EV.TLSDU).sum())
            tot["frag_ends"] += int((kinds == EV.FRAG_END).sum())
    return stats, tot


def traffic_outputs(plain_row, enc_row) -> dict:
    """The JAX bits path (native plane, keystore, 4 chunks) with dumpdir
    and decode_voice=True on one plain and one encrypted row: the npz
    arrays traffic_names [k] ('plain/<file>' or 'enc/<file>'),
    traffic_sizes [k] and traffic_bytes (the files' bytes, concatenated
    in name order)."""
    import tempfile
    from tetra_tpu.rx_multi import MultiCarrierReceiver
    bits = np.stack([plain_row, enc_row])
    cuts = np.linspace(0, bits.shape[1], 5).astype(int)
    names, blobs = [], []
    with tempfile.TemporaryDirectory() as tmp, jax_short_row_dumps():
        ks = pathlib.Path(tmp) / "keys.txt"
        ks.write_text(B.KEYSTORE)
        dd = pathlib.Path(tmp) / "dump"
        mc = MultiCarrierReceiver(np.zeros(2), fs=50_000.0,
                                  control_plane="native",
                                  keystore_path=str(ks), dumpdir=str(dd),
                                  decode_voice=True)
        for k in range(4):
            mc.process_bits(bits[:, cuts[k]:cuts[k + 1]], final=k == 3)
        for c, tag in enumerate(("plain", "enc")):
            for f in sorted((dd / f"carrier{c}").iterdir()):
                names.append(f"{tag}/{f.name}")
                blobs.append(f.read_bytes())
    assert any(n.endswith(".cod") for n in names)
    return {"traffic_names": np.asarray(names),
            "traffic_sizes": np.asarray([len(b) for b in blobs], np.int64),
            "traffic_bytes": np.frombuffer(b"".join(blobs), np.uint8)}


SNR8 = {"snr_db": 8.0, "snr8_crc_ok": 74_343, "snr8_crc_err": 410,
        "clean_crc_ok": 81_920}

# prod-1024 carriers whose per-carrier result the JAX wideband path is
# asked for: 304 and 610 decode fewer blocks than the bits path; the
# other six carry one raw traffic-bit error each in the port's dumps
PARITY_CHANNELS = (304, 610, 291, 337, 419, 518, 628, 989)


def wideband_parity(channels=PARITY_CHANNELS) -> dict:
    """The JAX package's wideband path (PFB front end, native plane,
    keystore) on the 1024-carrier production capture, built by the
    port's numpy capture code exactly as chip_smoke.py makes it, fed in the
    4 process_iq4c cuts of prod_fixture.run_receiver, with only
    `channels` synchronised and decoded (the PFB computes every bin).
    Dumps and voice are on, under jax_short_row_dumps. Returns the npz
    arrays jax_wideband_channels [n], jax_wideband_stats [n, 3]
    (bursts, crc_ok, crc_wrong) and jax_wideband_traffic_{names,sizes,
    bytes} ('<channel>/<file>', as traffic_outputs stores its files)."""
    import tempfile
    import time
    from tetra_tpu.rx_multi import MultiCarrierReceiver
    from tetra_tpu_torch import prod_fixture
    fx = prod_fixture.load()
    bits, _ = prod_fixture.mixed_bits(1024, 0.1, fx)
    packed = prod_fixture.wideband_capture(bits)
    cuts = np.linspace(0, len(packed), 5).astype(int)
    names, blobs = [], []
    with prod_fixture.keystore_file() as ks, \
            tempfile.TemporaryDirectory() as tmp, jax_short_row_dumps():
        mc = MultiCarrierReceiver([], fs=25_000.0 * 1024,
                                  pfb_channels=np.asarray(channels, np.int32),
                                  n_chan=1024, control_plane="native",
                                  keystore_path=ks, dumpdir=tmp,
                                  decode_voice=True)
        for k in range(4):
            t0 = time.perf_counter()
            mc.process_iq4c(packed[cuts[k]:cuts[k + 1]], final=k == 3)
            print(f"chunk {k}: {time.perf_counter() - t0:.1f} s", flush=True)
        stats = np.asarray([(c.stats.bursts, c.stats.crc_ok,
                             c.stats.crc_wrong) for c in mc.carriers],
                           np.int32)
        for i, ch in enumerate(channels):
            d = pathlib.Path(tmp) / f"carrier{i}"
            for f in sorted(d.iterdir()) if d.exists() else ():
                names.append(f"{ch}/{f.name}")
                blobs.append(f.read_bytes())
    return {"jax_wideband_channels": np.asarray(channels, np.int32),
            "jax_wideband_stats": stats,
            "jax_wideband_traffic_names": np.asarray(names),
            "jax_wideband_traffic_sizes": np.asarray([len(b) for b in blobs],
                                                     np.int64),
            "jax_wideband_traffic_bytes": np.frombuffer(b"".join(blobs),
                                                        np.uint8)}


def add_arrays(out: pathlib.Path, rec: dict) -> None:
    """Write rec's arrays into the npz file `out` in place, keeping every
    other array it holds as it is."""
    with np.load(out) as z:
        keep = {k: z[k] for k in z.files if k not in rec}
    np.savez_compressed(out, **keep, **rec)


def main_parity(out=ROOT / "tetra_tpu_torch" / "data" / "prod_mixed.npz"):
    """Add wideband_parity's arrays to the production fixture in place."""
    rec = wideband_parity()
    add_arrays(out, rec)
    print("jax wideband stats:", dict(zip(
        rec["jax_wideband_channels"].tolist(),
        rec["jax_wideband_stats"].tolist())))
    print(f"wrote {out} ({out.stat().st_size} bytes)")


def python_plane_record(channels=PARITY_CHANNELS) -> dict:
    """The JAX package's Python control plane:

    - tetra_tpu.rx.TetraReceiver (keystore, dumps and voice, under
      jax_short_row_dumps) on prod_fixture.rx_small_bits in one call:
      its log lines (jax_rx_small_log, NUL-joined bytes: a line may hold
      a newline), the digest
      of its TMV records (jax_rx_small_tmv), its stats and every file it
      writes (jax_rx_small_file_{names,sizes,bytes});
    - MultiCarrierReceiver(control_plane="python") on the 1024-carrier
      production capture as wideband_parity runs it (PFB front end,
      keystore, the 4 process_iq4c cuts of prod_fixture.run_receiver),
      with only `channels` decoded, each with its own log: per carrier
      (bursts, crc_ok, crc_wrong) and the digest of its log lines
      (jax_python_channels, jax_python_stats, jax_python_log_digests).
    """
    import tempfile
    import time
    from tetra_tpu.rx import TetraReceiver
    from tetra_tpu.rx_multi import MultiCarrierReceiver
    from tetra_tpu_torch import prod_fixture as P
    fx = P.load()
    rec = {}
    with P.keystore_file() as ks, tempfile.TemporaryDirectory() as tmp, \
            jax_short_row_dumps():
        lines = []
        rx = TetraReceiver(keystore_path=ks, dumpdir=tmp, decode_voice=True,
                           log=P.line_logger(lines))
        rx.tmv_records = []
        st = rx.process_bits(P.rx_small_bits(fx))
        files = P.read_tree(tmp)
        rec["jax_rx_small_log"] = np.frombuffer("\0".join(lines).encode(),
                                                np.uint8)
        rec["jax_rx_small_tmv"] = np.asarray(P.digest(rx.tmv_records))
        rec["jax_rx_small_stats"] = np.asarray(
            [st.bursts, st.crc_ok, st.crc_wrong], np.int32)
        rec["jax_rx_small_file_names"] = np.asarray(list(files))
        rec["jax_rx_small_file_sizes"] = np.asarray(
            [len(v) for v in files.values()], np.int64)
        rec["jax_rx_small_file_bytes"] = np.frombuffer(
            b"".join(files.values()), np.uint8)
        print(f"rx_small: {len(lines)} lines, {st}, {len(files)} files",
              flush=True)

        bits, _ = P.mixed_bits(1024, 0.1, fx)
        packed = P.wideband_capture(bits)
        cuts = np.linspace(0, len(packed), 5).astype(int)
        logs = [[] for _ in channels]
        mc = MultiCarrierReceiver([], fs=25_000.0 * 1024,
                                  pfb_channels=np.asarray(channels, np.int32),
                                  n_chan=1024, control_plane="python",
                                  keystore_path=ks,
                                  log=[P.line_logger(lg) for lg in logs])
        for k in range(4):
            t0 = time.perf_counter()
            mc.process_iq4c(packed[cuts[k]:cuts[k + 1]], final=k == 3)
            print(f"chunk {k}: {time.perf_counter() - t0:.1f} s", flush=True)
    rec["jax_python_channels"] = np.asarray(channels, np.int32)
    rec["jax_python_stats"] = np.asarray(
        [(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
         for c in mc.carriers], np.int32)
    rec["jax_python_log_digests"] = np.asarray([P.digest(lg) for lg in logs])
    return rec


def main_pyplane(out=ROOT / "tetra_tpu_torch" / "data" / "prod_mixed.npz"):
    """Add python_plane_record's arrays to the production fixture in
    place."""
    rec = python_plane_record()
    add_arrays(out, rec)
    print("jax python-plane stats:", dict(zip(
        rec["jax_python_channels"].tolist(),
        rec["jax_python_stats"].tolist())))
    print(f"wrote {out} ({out.stat().st_size} bytes)")


def snr8_row(seed: int = 0):
    """The padded clean row and n_tail, as bench_mc_e2e.run_snr8 builds
    them before the tile and the rolls."""
    rng = np.random.default_rng(seed)
    row = B.make_stream(rng, N_FRAMES)
    n_tail = B.common_len(N_FRAMES) - len(row)
    row = B.circular_safe_pad(row, rng, n_tail)
    return row.astype(np.uint8), n_tail


def main_snr8(out=ROOT / "tetra_tpu_torch" / "data" / "snr8_clean.npz"):
    row, n_tail = snr8_row()
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, row_packed=np.packbits(row),
                        length=np.int64(len(row)), n_tail=np.int64(n_tail),
                        n_frames=np.int64(N_FRAMES),
                        **{k: np.asarray(v) for k, v in SNR8.items()})
    print(f"wrote {out} ({out.stat().st_size} bytes)")


# snr8-1024 carriers whose per-carrier result the JAX soft path is asked
# for: the 5 with the fewest CRC-OK blocks and the 5 with the most CRC
# errors in the port's run on an H100 (chip_smoke.py's snr8 phase prints
# both lists), then the PFB's edges and centre
SNR8_PARITY_CHANNELS = (958, 145, 654, 529, 597, 109, 415, 571, 715, 764,
                        0, 1, 511, 512, 1022, 1023)


def soft_parity(channels=SNR8_PARITY_CHANNELS) -> dict:
    """The JAX package's soft wideband path (demod="soft", PFB front
    end, native plane) on the 1024-carrier snr8 capture, built by the
    port's numpy capture code exactly as chip_smoke.py makes it, fed in
    the 4 process_iq4c cuts of prod_fixture.run_receiver, with only
    `channels` synchronised and decoded (the PFB computes every bin).
    Returns the npz arrays jax_soft_channels [n] and jax_soft_stats
    [n, 3] (bursts, crc_ok, crc_wrong)."""
    import time
    from tetra_tpu.rx_multi import MultiCarrierReceiver
    from tetra_tpu_torch import prod_fixture
    packed = prod_fixture.snr8_capture(1024)
    cuts = np.linspace(0, len(packed), 5).astype(int)
    mc = MultiCarrierReceiver([], fs=25_000.0 * 1024,
                              pfb_channels=np.asarray(channels, np.int32),
                              n_chan=1024, control_plane="native",
                              demod="soft")
    for k in range(4):
        t0 = time.perf_counter()
        mc.process_iq4c(packed[cuts[k]:cuts[k + 1]], final=k == 3)
        print(f"chunk {k}: {time.perf_counter() - t0:.1f} s", flush=True)
    stats = np.asarray([(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
                        for c in mc.carriers], np.int32)
    return {"jax_soft_channels": np.asarray(channels, np.int32),
            "jax_soft_stats": stats}


def main_snr8parity(out=ROOT / "tetra_tpu_torch" / "data" / "snr8_clean.npz"):
    """Add soft_parity's arrays to the snr8 fixture in place."""
    rec = soft_parity()
    add_arrays(out, rec)
    print("jax soft stats:", dict(zip(rec["jax_soft_channels"].tolist(),
                                      rec["jax_soft_stats"].tolist())))
    print(f"wrote {out} ({out.stat().st_size} bytes)")


def mixer_record() -> dict:
    """The JAX package's mixer-bank records, written to
    tetra_tpu_torch/data/mixer_offgrid.npz (prod_fixture.load_mixer):

    - mixer-64: mixed_bits(64, 0.1) (6 TEA1 carriers), carrier k at the
      exact bin nearest 25 kHz x (k - 32) + 1,370 Hz, fs 1.8 MS/s, built
      by the port's numpy code (prod_fixture.mixer_capture, as
      chip_smoke.py builds it), converted as rtl_tcp's client converts
      it and fed in run_rtltcp's 0.5 s chunks to tetra_tpu's mixer-bank
      MultiCarrierReceiver with the keystore, on the Python plane (logs
      kept on MIXER_LOG_CHANNELS) and on the native plane, which must
      agree; and scan.detect_carriers on the same capture (its
      candidates and the power of each raster channel);
    - the two-cell capture of tests/test_rx_multi at 144 kHz with the
      off-grid offsets -31,400 and +13,700 Hz (its bits stored);
    - the 400 kHz two-cell u8 capture of tests/test_sdr.make_wideband
      (stored): scan.scan(confirm=True), and the CLI's --rtltcp
      --carriers auto (Python plane) against a mock rtl_tcp server."""
    import time
    from tetra_tpu import receiver as jax_receiver
    from tetra_tpu import scan as jax_scan
    from tetra_tpu.io.sdr import RtlTcpSource
    from tetra_tpu.rx_multi import MultiCarrierReceiver
    from tests.test_rx_multi import _capture_bits
    from tests.test_sdr import make_wideband
    from tetra_tpu_torch import prod_fixture as P
    import rtl_tcp_mock

    rec = {}
    fx = P.load()
    bits, n_enc = P.mixed_bits(P.MIXER_CARRIERS, 0.1, fx)
    assert n_enc == 6
    bins = P.mixer_bins(P.MIXER_CARRIERS, bits.shape[1])
    dur = bits.shape[1] / P.DEMOD_RATE
    offsets = (bins / dur).astype(np.float32)
    t0 = time.perf_counter()
    u8 = P.mixer_capture(bits, bins)
    print(f"mixer-64 capture: {len(u8) // 2} samples, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    iq = RtlTcpSource._to_complex(u8)
    runs = {}
    logs = {c: [] for c in P.MIXER_LOG_CHANNELS}    # the Python plane's
    with P.keystore_file() as ks:
        for plane in ("python", "native"):
            t0 = time.perf_counter()
            mc = MultiCarrierReceiver(
                offsets, fs=P.MIXER_FS, keystore_path=ks,
                control_plane=plane,
                log=[P.line_logger(logs[c]) if c in logs
                     else (lambda *a: None) for c in range(P.MIXER_CARRIERS)]
                if plane == "python" else None)
            for i in range(0, len(iq), P.MIXER_CHUNK):
                mc.process_iq(iq[i:i + P.MIXER_CHUNK], final=False)
            mc.process_iq(np.zeros(0, np.complex64), final=True)
            runs[plane] = mc
            print(f"mixer-64 {plane} plane: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    stats = lambda m: np.asarray([(c.stats.bursts, c.stats.crc_ok,
                                   c.stats.crc_wrong) for c in m.carriers],
                                 np.int32)
    assert np.array_equal(stats(runs["python"]), stats(runs["native"]))
    rec["mixer_rows"] = np.arange(P.MIXER_CARRIERS, dtype=np.int64)
    rec["mixer_bins"] = bins
    rec["mixer_offsets"] = offsets
    rec["mixer_fs"] = np.float64(P.MIXER_FS)
    rec["jax_mixer_stats"] = stats(runs["python"])
    rec["jax_mixer_cells"] = np.asarray(
        [(c.mcc, c.mnc, c.colour_code) for c in runs["python"].carriers],
        np.int32)
    rec["jax_mixer_log_channels"] = np.asarray(P.MIXER_LOG_CHANNELS,
                                               np.int32)
    rec["jax_mixer_log_digests"] = np.asarray(
        [P.digest(logs[c]) for c in P.MIXER_LOG_CHANNELS])
    det_off, det_snr, (_, power, _) = jax_scan.detect_carriers(
        iq, P.MIXER_FS)
    rec["jax_mixer_detect_offsets"] = np.asarray(det_off, np.float64)
    rec["jax_mixer_detect_snr"] = np.asarray(det_snr, np.float64)
    rec["jax_mixer_channel_power"] = np.asarray(power, np.float64)

    # the two-cell capture of tests/test_rx_multi, off the grid at 144 kHz
    a = _capture_bits(262, 42, 1, 0x200, seed=1)
    b = _capture_bits(901, 7, 5, 0x300, seed=2)
    n = min(len(a), len(b)) & ~1
    small = np.stack([a[:n], b[:n]]).astype(np.uint8)
    rec["small_bits_packed"] = np.packbits(small, axis=1)
    rec["small_len"] = np.int64(n)
    rec["small_offsets"] = np.asarray([-31_400.0, 13_700.0], np.float32)
    rec["small_fs"] = np.float64(144_000.0)
    wide, off_s, fs_s = P.small_capture(
        {"small_bits": small, "small_offsets": rec["small_offsets"],
         "small_fs": rec["small_fs"]})
    mc = MultiCarrierReceiver(off_s, fs=fs_s)
    mc.process_iq(wide)
    rec["jax_small_stats"] = np.asarray(
        [(c.stats.bursts, c.stats.slots, c.stats.crc_ok, c.stats.crc_wrong)
         for c in mc.carriers], np.int32)
    rec["jax_small_cells"] = np.asarray(
        [(c.mcc, c.mnc, c.colour_code) for c in mc.carriers], np.int32)
    rec["jax_small_ssis"] = np.asarray(
        [[e[1].addr.ssi for e in c.umac.events
          if e[0] == "RESOURCE" and e[1].addr.type == 1]
         for c in mc.carriers], np.int32)

    # the 400 kHz two-cell capture of tests/test_sdr: scan and --carriers auto
    fs = 400_000.0
    u8s, _ = make_wideband(fs)
    rec["scan_u8"] = u8s
    rec["scan_fs"] = np.float64(fs)
    results, _ = jax_scan.scan(RtlTcpSource._to_complex(u8s), fs,
                               confirm=True)
    rec["jax_scan_offsets"] = np.asarray([r["offset_hz"] for r in results])
    rec["jax_scan_snr"] = np.asarray([r["snr_db"] for r in results])
    rec["jax_scan_confirmed"] = np.asarray([r["confirmed"] for r in results])
    rec["jax_scan_cells"] = np.asarray(
        [(r["mcc"], r["mnc"], r["colour_code"]) for r in results], np.int32)
    rec["jax_scan_crc_ok"] = np.asarray([r["crc_ok"] for r in results],
                                        np.int32)
    with rtl_tcp_mock.serve(rtl_tcp_mock.scan_payload(u8s, fs)) as srv:
        mrx = jax_receiver.main([
            "--rtltcp", f"127.0.0.1:{srv.port}", "--rate", str(fs),
            "--carriers", "auto", "--secs", repr((len(u8s) // 2 + 0.5) / fs)])
    rec["jax_auto_stats"] = np.asarray(
        [(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
         for c in mrx.carriers], np.int32)
    rec["jax_auto_cells"] = np.asarray(
        [(c.mcc, c.mnc, c.colour_code) for c in mrx.carriers], np.int32)
    return rec


def main_mixer(out=ROOT / "tetra_tpu_torch" / "data" / "mixer_offgrid.npz"):
    rec = mixer_record()
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **rec)
    print("jax mixer-64 totals (bursts, crc_ok, crc_wrong):",
          rec["jax_mixer_stats"].sum(0).tolist(),
          "detect:", rec["jax_mixer_detect_offsets"].tolist(),
          "scan:", rec["jax_scan_offsets"].tolist(),
          "auto:", rec["jax_auto_stats"].tolist())
    print(f"wrote {out} ({out.stat().st_size} bytes)")


STEADY_SLOTS = 64


def steady_slots(seed: int = 0):
    """The steady fixture's slots [64, 510], kinds [64] and type-1
    payloads by block (zero on slots of another kind), made by
    tetra_tpu's TX chain with the cell code of MCC 262 / MNC 42 / CC 1."""
    import jax.numpy as jnp
    from tetra_tpu import tx, testpdu
    from tetra_tpu.ops.scramble import scramb_get_init
    init = scramb_get_init(262, 42, 1)
    rng = np.random.default_rng(seed)
    n = STEADY_SLOTS
    slots = np.zeros((n, 510), np.uint8)
    kinds = np.arange(n, dtype=np.int32) % 3
    pay = {"sb1": np.zeros((n, 60), np.uint8),
           "sb2": np.zeros((n, 124), np.uint8),
           "schf": np.zeros((n, 268), np.uint8),
           "ndb1": np.zeros((n, 124), np.uint8),
           "ndb2": np.zeros((n, 124), np.uint8),
           "aach": np.zeros((n, 14), np.uint8)}
    for s in range(n):
        aa = testpdu.make_access_assign_bits(hdr=s % 4, f1=s % 64,
                                             f2=(7 * s) % 64)
        pay["aach"][s] = aa
        if kinds[s] == 0:
            p1 = testpdu.make_sync_pdu(cc=1, tn=s % 4 + 1, fn=s // 4 + 1,
                                       mcc=262, mnc=42)
            p2 = testpdu.make_sysinfo_pdu(la=1000 + s)
            pay["sb1"][s], pay["sb2"][s] = p1, p2
            b = tx.make_sync_burst(p1, p2, aa, jnp.uint32(init))
        elif kinds[s] == 1:
            p = testpdu.make_resource_pdu(ssi=0x500 + s)
            pay["schf"][s] = p
            b = tx.make_schf_burst(p, aa, jnp.uint32(init))
        else:
            b1 = rng.integers(0, 2, 124).astype(np.int8)
            b2 = rng.integers(0, 2, 124).astype(np.int8)
            pay["ndb1"][s], pay["ndb2"][s] = b1, b2
            b = tx.make_ndb_burst(b1, b2, aa, jnp.uint32(init))
        slots[s] = b
    return slots, kinds, pay, init


def main_steady(out=ROOT / "tetra_tpu_torch" / "data" / "steady_mixed.npz"):
    import jax.numpy as jnp
    from tetra_tpu.lmac import steady
    from tetra_tpu_torch.steady_fixture import BLOCKS
    slots, kinds, pay, init = steady_slots()
    # the JAX chain decodes every slot of the fixture to its payloads
    res = steady.locked_step_bits(jnp.asarray(slots[None].astype(np.int8)),
                                  jnp.asarray(np.array([init], np.uint32)))
    assert np.array_equal(np.asarray(res["kinds"])[0], kinds)
    assert np.asarray(res["crc_ok"]).all()
    for key, (rkey, kind) in BLOCKS.items():
        on = kinds == kind if kind is not None else slice(None)
        got = np.asarray(res[rkey].type1)[0]
        assert np.array_equal(got[on], pay[key][on]), key
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, slots_packed=np.packbits(slots, axis=1),
                        kinds=kinds, init=np.int64(init), pad=np.int64(64),
                        **{f"{k}_packed": np.packbits(v, axis=1)
                           for k, v in pay.items()})
    print(f"wrote {out} ({out.stat().st_size} bytes)")


def main_eq(out=ROOT / "tetra_tpu_torch" / "data" / "eq_degraded.npz"):
    """The JAX equalised chain (locked_step_ri(fast="eq"), the fused
    decode) on the recorded carriers of the degraded capture."""
    import jax.numpy as jnp
    from tetra_tpu.lmac import steady
    from tetra_tpu_torch import steady_fixture as sf
    fx = sf.load()
    car = np.asarray(sf.EQ_RECORD)
    re, im = sf.eq_capture(sf.EQ_CAR, car, sf.EQ_SEED, fx)
    res = steady.locked_step_ri(
        jnp.asarray(re), jnp.asarray(im),
        jnp.asarray(np.full(len(car), fx["init"], np.uint32)),
        phase_bit=sf.PHASE_BIT, n_slots=sf.N_SLOTS, fast="eq",
        decoders=("fused",))
    kinds = np.asarray(res["kinds"]).astype(np.int8)
    crc_ok = np.asarray(res["crc_ok"])
    groups = list(sf.EQ_GROUPS.values())
    taps = np.zeros((len(groups), 3), np.complex64)
    for g, (h, _, _) in enumerate(groups):
        taps[g, :len(h)] = h
    np.savez_compressed(
        out, carriers=car, kinds=kinds, crc_ok=crc_ok,
        n_car=np.int64(sf.EQ_CAR), seed=np.int64(sf.EQ_SEED), taps=taps,
        cfo=np.asarray([g[1] for g in groups]),
        snr_db=np.asarray([g[2] for g in groups]))
    g = sf.eq_group(sf.EQ_CAR, car)
    print({k: f"{int(crc_ok[g == i].sum())}/{crc_ok[g == i].size}"
           for i, k in enumerate(sf.EQ_GROUPS)})
    print(f"wrote {out} ({out.stat().st_size} bytes)")


def main(out=ROOT / "tetra_tpu_torch" / "data" / "prod_mixed.npz"):
    plain, enc, n_tail = rows()
    # the stored rows must rebuild mixed_batch exactly
    from tetra_tpu_torch import prod_fixture
    fx = {"plain": plain, "enc": enc, "n_tail": n_tail}
    got, n_enc = prod_fixture.mixed_bits(1024, 0.1, fx)
    want, _ = B.mixed_batch(1024, N_FRAMES, enc_frac=0.1)
    assert np.array_equal(got, want), "fixture rows do not rebuild mixed_batch"
    stats, tot = bits_path_stats(got)
    tot["crc_ok"] = int(stats[:, 1].sum())
    tot["crc_err"] = int(stats[:, 2].sum())
    for k, v in tot.items():
        assert v == REF_WINDOW[k][1], (k, v, REF_WINDOW[k])
    assert n_enc == REF_WINDOW["n_encrypted"][0]
    refs = {f"ref_{k}": np.asarray(v, np.int64) for k, v in REF_WINDOW.items()}
    traffic = traffic_outputs(got[0], got[-1])
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, plain_packed=np.packbits(plain),
                        enc_packed=np.packbits(enc),
                        length=np.int64(len(plain)), n_tail=np.int64(n_tail),
                        n_frames=np.int64(N_FRAMES),
                        jax_bits_stats=stats, **refs, **traffic)
    print(f"wrote {out} ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    modes = ["prod", "parity", "pyplane", "snr8", "snr8parity", "steady",
             "mixer", "eq"]
    which = sys.argv[1:] or modes
    if not set(which) <= set(modes):
        sys.exit(f"usage: {sys.argv[0]} [{'|'.join(modes)}]")
    if "prod" in which:
        main()
    if "parity" in which:
        main_parity()
    if "pyplane" in which:
        main_pyplane()
    if "snr8" in which:
        main_snr8()
    if "snr8parity" in which:
        main_snr8parity()
    if "steady" in which:
        main_steady()
    if "mixer" in which:
        main_mixer()
    if "eq" in which:
        main_eq()
