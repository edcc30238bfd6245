"""The PyTorch port's single-carrier receiver (tetra_tpu_torch.rx, the
tetra-rx analogue) and its parts vs tetra_tpu on the CPU, from seeded
inputs: the synchroniser (compute_match_map, align_stream, MultiSync),
decode_slots_multi in both return forms, TetraReceiver on the
end-to-end, damaged, traffic, encrypted and defrag captures, the CLI's
stdout for each capture format, the angle-path demod and slicers, the
ingest quantizers and the trace module.

Everything is exact (bits, events, log lines, TMV records, upper-MAC
events, files) except `demodulate`'s float symbols, held within 1e-4.
The JAX dump writer raises on an NDB slot's 216-bit traffic row; its
side runs under make_torch_fixture.jax_short_row_dumps, which writes
such a row as the port does.
"""
import contextlib
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._torch_util import CPU
from tests.test_rx_e2e import INIT, build_capture
from tests.test_sync_vec import make_stream

from tetra_tpu import rx as j_rx
from tetra_tpu.io import stream as j_stream
from tetra_tpu.phy import dqpsk as j_dqpsk, sync as j_sync, \
    sync_vec as j_sync_vec

from tetra_tpu_torch import prod_fixture, rx
from tetra_tpu_torch.io import stream
from tetra_tpu_torch.phy import dqpsk, sync, sync_vec

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import make_torch_fixture  # noqa: E402


# ---- synchroniser -------------------------------------------------------

@pytest.mark.parametrize("length", [37, 38, 600, 8192, 9001])
def test_compute_match_map_columns(length):
    """Columns 0-2 (SYNC, NORM_1, NORM_2) equal tetra_tpu's map, 1-D and
    [B, L], at lengths around the 8192-bit bucket and the shortest
    template fit."""
    s = np.tile(make_stream(11, n_frames=3), 3)
    rng = np.random.default_rng(length)
    bits = np.stack([s[:length], rng.integers(0, 2, length).astype(np.uint8)])
    want = np.asarray(j_sync.compute_match_map(bits))[..., :3]
    if length < 38:
        want = np.zeros(bits.shape + (3,), bool)
    assert np.array_equal(sync.compute_match_map(bits, CPU), want)
    assert np.array_equal(sync.compute_match_map(bits[0], CPU), want[0])
    if length > 600:
        assert want[0].any()


def _align(mod, bits, cuts, flush_last=True, **kw):
    """align_stream over bits fed in the chunks cut at `cuts`, with the
    carry and the buffer trim of TetraReceiver: ([slot], [event]) as
    tuples with absolute offsets."""
    carry = mod.SyncCarry()
    buf, base = np.zeros(0, np.uint8), 0
    slots, events = [], []
    edges = [0, *cuts, len(bits)]
    for k in range(len(edges) - 1):
        buf = np.concatenate([buf, bits[edges[k]:edges[k + 1]]])
        ev = []
        out = mod.align_stream(buf, events=ev, carry=carry, base_offset=base,
                               flush=flush_last and k == len(edges) - 2, **kw)
        slots += [(s.offset + base, s.train_id, s.slot_index, s.seq)
                  for s in out]
        events += [(e.kind, e.offset + base, e.detail, e.seq) for e in ev]
        keep = max(base, carry.buf_start)
        buf, base = buf[keep - base:], keep
    return slots, events


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_align_stream_matches_jax(seed):
    """Random corrupted streams (relocks, bit errors, a random span),
    whole and in uneven chunks, flushed and not: identical slots and
    events."""
    bits = make_stream(seed, n_frames=4)
    L = len(bits)
    for cuts in ([], [999, L // 2, L // 2 + 21], [64 * 37 + 5]):
        for flush in (True, False):
            want = _align(j_sync, bits, cuts, flush)
            assert _align(sync, bits, cuts, flush, device=CPU) == want
            assert want[0]


def _multisync(mod, batch, cuts, **kw):
    ms = mod.MultiSync(batch.shape[0], **kw)
    out = [([], []) for _ in range(batch.shape[0])]
    base = 0
    buf = batch[:, :0]
    edges = [0, *cuts, batch.shape[1]]
    for k in range(len(edges) - 1):
        buf = np.concatenate([buf, batch[:, edges[k]:edges[k + 1]]], 1)
        sl, ev = ms.scan(buf, base_offset=base)
        for b in range(batch.shape[0]):
            out[b][0].extend((s.offset, s.train_id, s.slot_index, s.seq)
                             for s in sl[b])
            out[b][1].extend((e.kind, e.offset, e.detail, e.seq)
                             for e in ev[b])
        keep = max(base, ms.min_buf_start())
        buf, base = buf[:, keep - base:], keep
    return out, ms.carry


def test_multisync_matches_jax():
    """Six corrupted streams, whole and in uneven chunks: identical
    per-carrier slots, events and carry."""
    streams = [make_stream(300 + b, n_frames=3) for b in range(6)]
    L = min(len(s) for s in streams)
    batch = np.stack([s[:L] for s in streams])
    for cuts in ([], [999, L // 2, L // 2 + 20]):
        want, jc = _multisync(j_sync_vec, batch, cuts)
        got, pc = _multisync(sync_vec, batch, cuts, device=CPU)
        assert got == want
        for f in ("state", "buf_start", "bits_in_buf", "nfs", "slot_index"):
            assert np.array_equal(getattr(pc, f), getattr(jc, f)), f
        assert pc.fed == jc.fed and sum(len(w[0]) for w in want) > 10


# ---- decode_slots_multi --------------------------------------------------

@pytest.fixture(scope="module")
def multi_case():
    """Three corrupted carriers, their slots from the JAX synchroniser and
    per-carrier start codes, with both JAX return forms."""
    streams = [make_stream(400 + b, n_frames=8) for b in range(3)]
    slots = [j_sync.align_stream(s) for s in streams]
    inits = [0, INIT, 0x12345678]
    return (streams, slots, inits,
            j_rx.decode_slots_multi(streams, slots, inits),
            j_rx.decode_slots_multi(streams, slots, inits, packed=True))


def test_decode_slots_multi_matches_jax(multi_case):
    streams, slots, inits, want, _ = multi_case
    port_slots = [[sync.AlignedSlot(s.offset, s.train_id, s.slot_index, s.seq)
                   for s in sl] for sl in slots]
    got = rx.decode_slots_multi(streams, port_slots, inits, device=CPU)
    assert [len(x) for x in got] == [len(x) for x in want]
    n_blocks = 0
    for gc, wc in zip(got, want):
        for g, w in zip(gc, wc):
            assert g.keys() == w.keys() and g["kind"] == w["kind"]
            for k in w:
                if k == "kind":
                    continue
                if k == "t4":
                    assert np.array_equal(g[k], np.asarray(w[k]))
                    assert g[k].dtype == np.asarray(w[k]).dtype
                    continue
                for a, b in zip(g[k], w[k]):
                    assert np.array_equal(a, np.asarray(b)), k
                    assert a.dtype == np.asarray(b).dtype, k
                n_blocks += 1
    assert n_blocks > 100


def test_decode_slots_multi_packed_matches_jax(multi_case):
    streams, slots, inits, _, want = multi_case
    port_slots = [[sync.AlignedSlot(s.offset, s.train_id, s.slot_index, s.seq)
                   for s in sl] for sl in slots]
    got = rx.decode_slots_multi(streams, port_slots, inits, packed=True,
                                device=CPU)
    assert np.array_equal(got["packed"], np.asarray(want["packed"]))
    assert np.array_equal(got["kinds"], want["kinds"])
    assert [(c, j, s.offset) for c, j, s in got["entries"]] == \
        [(c, j, s.offset) for c, j, s in want["entries"]]
    assert got["t4_pos"] == want["t4_pos"]
    for k in ("t4_full", "t4_b2"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    empty = rx.decode_slots_multi([streams[0]], [[]], [0], packed=True,
                                  device=CPU)
    assert empty["packed"].shape == (0, 408) and empty["t4_full"] is None


# ---- TetraReceiver -------------------------------------------------------

def _voice_capture():
    """tests/test_rx_e2e.py::TestVoiceDecode's capture: two sync bursts
    and a TCH/S traffic slot (AACH usage 5)."""
    import jax.numpy as jnp
    from tetra_tpu import testpdu, tx
    from tetra_tpu.ops import acelp
    from tetra_tpu.ops.scramble import scramb_bits
    from tetra_tpu.phy.burst import build_norm_c_d_burst
    rng = np.random.default_rng(7)
    cls = [rng.integers(0, 2, n).astype(np.int8)[None] for n in (102, 108, 64)]
    t3 = np.asarray(acelp.tch_s_encode(*map(jnp.asarray, cls)))[0]
    t5 = np.asarray(scramb_bits(jnp.uint32(INIT), jnp.asarray(t3)))
    sync_pdu = testpdu.make_sync_pdu(cc=1, tn=1, fn=1, mn=1, mcc=262, mnc=42)
    sb = tx.make_sync_burst(sync_pdu, testpdu.make_sysinfo_pdu(),
                            testpdu.make_access_assign_bits(),
                            jnp.uint32(INIT))
    bb = np.asarray(tx.encode_bbk(jnp.asarray(
        testpdu.make_access_assign_bits(hdr=3, f1=5, f2=0)), jnp.uint32(INIT)))
    return np.concatenate([
        np.random.default_rng(1).integers(0, 2, 91).astype(np.uint8),
        np.asarray(sb, np.uint8), np.asarray(sb, np.uint8),
        build_norm_c_d_burst(t5[:216], bb, t5[216:], False)])


def _encrypted_capture(tmp_path):
    """tests/test_encrypted_e2e.py's capture (a TEA1-encrypted
    MAC-RESOURCE) and its keystore file."""
    import jax.numpy as jnp
    from tests import test_encrypted_e2e as E
    from tetra_tpu import testpdu, tx
    from tetra_tpu.crypto.crypto import generate_keystream
    from tetra_tpu.tdma import TdmaTime
    from tetra_tpu.umac import mac_pdu
    from tetra_tpu.utils.bits import uint_to_bits
    ks = tmp_path / "keys.txt"
    ks.write_text(E._keystore_text())
    pdu = np.array(testpdu.make_resource_pdu(
        ssi=0x1234, sdu_bits=testpdu.make_bl_udata(
            testpdu.make_mle_cmce_dsetup()), fill=False))
    pdu[4:6] = [0, 1]
    rsd = mac_pdu.decode_resource(pdu)
    tcs, key = E._tx_crypto_state()
    key_bits = generate_keystream(tcs, key, TdmaTime(tn=2, fn=2, mn=3),
                                  rsd.macpdu_length * 8 - rsd.bit_len)
    pdu[rsd.bit_len:rsd.macpdu_length * 8] ^= key_bits
    sysinfo = np.array(testpdu.make_sysinfo_pdu(main_carrier=E.MAIN_CARRIER,
                                                la=E.LA))
    sysinfo[43] = 1
    sysinfo[44:60] = uint_to_bits(E.CCK_ID, 16)
    aach = testpdu.make_access_assign_bits()
    sb = tx.make_sync_burst(testpdu.make_sync_pdu(cc=1, tn=1, fn=2, mn=3,
                                                  mcc=262, mnc=42),
                            sysinfo, aach, jnp.uint32(INIT))
    return np.concatenate([
        np.random.default_rng(3).integers(0, 2, 113).astype(np.uint8),
        np.asarray(sb, np.uint8), np.asarray(sb, np.uint8),
        np.asarray(tx.make_schf_burst(pdu.astype(np.int8), aach,
                                      jnp.uint32(INIT)), np.uint8)]), str(ks)


def _capture(name, tmp_path):
    """(bits, keystore path or None) of a named capture."""
    if name in ("e2e", "hole", "truncated"):
        bits = build_capture(n_frames=4, seed=5)[0].copy()
        if name == "hole":
            mid = len(bits) // 2
            bits[mid:mid + 200] ^= 1
        if name == "truncated":
            bits = bits[:len(bits) - 777]
        return bits, None
    if name == "empty":
        return np.zeros(0, np.uint8), None
    if name == "voice":
        return _voice_capture(), None
    if name == "encrypted":
        return _encrypted_capture(tmp_path)
    if name == "defrag":
        from tests.test_torch_egress import _defrag_capture
        return _defrag_capture()[0][1], None
    if name == "prod":
        (tmp_path / "keys.txt").write_text(prod_fixture.KEYSTORE)
        return prod_fixture.rx_small_bits(), str(tmp_path / "keys.txt")
    raise ValueError(name)


def _run_rx(cls, bits, ks, dumpdir, chunks=1, **kw):
    """One receiver with dumps, voice and TMV records over bits in
    `chunks` calls (final=False, then an empty final call): (receiver,
    log lines, files, TUN packets)."""
    lines = []
    r = cls(keystore_path=ks, dumpdir=str(dumpdir), decode_voice=True,
            log=prod_fixture.line_logger(lines), **kw)
    r.tmv_records = []
    tun = []
    r._ip_out = tun.append
    r.llc.ip_cb = r._ip_out
    if chunks == 1:
        r.process_bits(bits)
    else:
        for part in np.array_split(bits, chunks):
            r.process_bits(part, final=False)
        r.process_bits(bits[:0], final=True)
    return r, lines, prod_fixture.read_tree(dumpdir), tun


CAPTURES = ["e2e", "hole", "truncated", "empty", "voice", "encrypted",
            "defrag", "prod"]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX receiver on every capture, once."""
    out = {}
    for name in CAPTURES:
        tmp = tmp_path_factory.mktemp(f"jax_{name}")
        bits, ks = _capture(name, tmp)
        with make_torch_fixture.jax_short_row_dumps():
            out[name] = (bits, ks, _run_rx(j_rx.TetraReceiver, bits, ks,
                                           tmp / "dump"))
    return out


def _same(got, want):
    g, gl, gf, gt = got
    w, wl, wf, wt = want
    assert gl == wl
    assert g.stats == rx.RxStats(**vars(w.stats))
    assert g.tmv_records == w.tmv_records
    assert repr(g.umac.events) == repr(w.umac.events)
    assert gf == wf
    assert gt == wt
    assert (g.mcc, g.mnc, g.colour_code, g.scramb_init) == \
        (w.mcc, w.mnc, w.colour_code, w.scramb_init)
    assert (g.time.tn, g.time.fn, g.time.mn) == (w.time.tn, w.time.fn,
                                                  w.time.mn)


@pytest.mark.parametrize("name", CAPTURES)
def test_tetra_receiver_matches_jax(name, jax_runs, tmp_path):
    """Log lines, stats, TMV records, upper-MAC events, dump and voice
    files, TUN packets, cell identity and TDMA time equal the JAX
    receiver's, in one call and in three chunks."""
    bits, ks, want = jax_runs[name]
    for chunks in (1, 3):
        got = _run_rx(rx.TetraReceiver, bits, ks, tmp_path / f"d{chunks}",
                      chunks=chunks, device=CPU)
        _same(got, want)
    r, lines, files, tun = want
    if name == "e2e":
        assert r.stats.crc_ok == 20 and r.stats.crc_wrong == 0
    if name == "hole":
        assert sum("found SYNC" in ln for ln in lines) == 2
    if name in ("voice", "prod"):
        assert any(k.endswith(".cod") for k in files)
    if name == "encrypted":
        assert any("DECRYPTED" in ln for ln in lines)
    if name == "defrag":
        assert len(tun) == 1
    if name == "empty":
        assert not lines and r.stats == j_rx.RxStats()


def test_prod_carrier_matches_fixture_record(jax_runs):
    """The JAX receiver's run on the prod carrier equals the record
    stored in the fixture, which chip_smoke.py holds the card to."""
    rec = prod_fixture.python_record(prod_fixture.load())["rx_small"]
    r, lines, files, _ = jax_runs["prod"][2]
    assert lines == rec["log"]
    assert prod_fixture.digest(r.tmv_records) == rec["tmv"]
    assert (r.stats.bursts, r.stats.crc_ok, r.stats.crc_wrong) == \
        rec["stats"]
    assert files == rec["files"]


# ---- the CLI ------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """One capture (build_capture, an even bit count) as .bits, float
    symbols with noise (.fl) and complex IQ (.cfile)."""
    tmp = tmp_path_factory.mktemp("cli")
    bits = build_capture(n_frames=3, noise_prefix=138, seed=9)[0]
    rng = np.random.default_rng(9)
    paths = {"bits": tmp / "cap.bits", "float": tmp / "cap.fl",
             "iq": tmp / "cap.cfile"}
    bits.astype(np.uint8).tofile(paths["bits"])
    syms = j_dqpsk.bits_to_phase(bits).astype(np.float32)
    (syms + rng.normal(0, 0.3, syms.shape).astype(np.float32)).tofile(
        paths["float"])
    dqpsk.modulate(bits, sps=2).tofile(paths["iq"])
    return paths


@pytest.mark.parametrize("fmt", ["bits", "float", "iq"])
def test_main_stdout_matches_jax(fmt, cli_files, tmp_path):
    """`main -f <fmt> -d DIR --voice capture`: the same stdout (log lines
    and the summary) and dump directory as tetra_tpu.rx.main."""
    outs = []
    for name, main, extra in (("jax", j_rx.main, []),
                              ("port", rx.main, ["--device", "cpu"])):
        d = tmp_path / name
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([*extra, "-f", fmt, "-d", str(d), "--voice",
                  str(cli_files[fmt])])
        outs.append((buf.getvalue(), prod_fixture.read_tree(d)))
    assert outs[0] == outs[1]
    assert int(outs[0][0].rsplit("=", 1)[1].split("/")[0]) > 10


def test_cli_runs_without_jax(cli_files):
    """python -m tetra_tpu_torch.rx --device cpu in a fresh interpreter:
    the summary line, and no jax or tetra_tpu module imported (the
    interpreter's own import log)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "tetra_tpu_torch.rx",
         "--device", "cpu", "-f", "bits", str(cli_files["bits"])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.rstrip().endswith("CRC ok/wrong = 15/0")
    mods = [ln.rsplit("|", 1)[-1].strip() for ln in out.stderr.splitlines()
            if ln.startswith("import time:")]
    assert "tetra_tpu_torch.umac.upper_mac" in mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "tetra_tpu")]
    assert not bad, bad


# ---- demod and slicers ---------------------------------------------------

def test_float_to_bits_and_phase_to_bits_exact():
    """float_to_bits and phase_to_bits (with and without the AFC, on a
    drift ramp) bit-exact against tetra_tpu, thresholds included."""
    import jax.numpy as jnp
    rng = np.random.default_rng(31)
    syms = np.concatenate([rng.uniform(-4, 4, 4000),
                           [0.0, 2.0, -2.0, 1e-7, -1e-7, 2 + 1e-6, -2 - 1e-6,
                            6.0, -6.0]]).astype(np.float32)
    want = np.asarray(j_dqpsk.float_to_bits(jnp.asarray(syms)))
    got = dqpsk.float_to_bits(torch.as_tensor(syms)).numpy()
    assert np.array_equal(got, want) and got.dtype == want.dtype
    assert np.array_equal(dqpsk.float_to_bits(syms[None]).numpy()[0], want)
    bits = rng.integers(0, 2, 2 * 3000).astype(np.int8)
    ramp = j_dqpsk.bits_to_phase(bits).astype(np.float32) \
        + np.linspace(0, 0.9, 3000, dtype=np.float32)
    for s in (syms, ramp):
        for kw in ({}, {"afc": True}, {"afc": True, "filter_val": 0.01,
                                       "filter_goal": 0.1}):
            assert np.array_equal(dqpsk.phase_to_bits(s, **kw),
                                  j_dqpsk.phase_to_bits(s, **kw))


@pytest.mark.parametrize("cfo", [0.0, 0.002])
def test_demodulate_matches_jax(cfo):
    """demodulate within 1e-4 of tetra_tpu's phase symbols, decisions
    identical on a clean capture, with and without the CFO estimate."""
    import jax.numpy as jnp
    rng = np.random.default_rng(32)
    bits = rng.integers(0, 2, (3, 2 * 700)).astype(np.int8)
    iq = dqpsk.modulate(bits, sps=2)
    iq = (iq * np.exp(1j * 2 * np.pi * cfo * np.arange(iq.shape[-1]))
          ).astype(np.complex64)
    for est in (True, False):
        want = np.asarray(j_dqpsk.demodulate(jnp.asarray(iq), sps=2,
                                             est_cfo=est))
        got = dqpsk.demodulate(iq, sps=2, est_cfo=est, device=CPU).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4
        if est or cfo == 0.0:
            assert np.array_equal(dqpsk.float_to_bits(got).numpy(),
                                  np.asarray(j_dqpsk.float_to_bits(want)))
    one = dqpsk.demodulate(iq[0], device=CPU).numpy()
    assert np.abs(one - np.asarray(j_dqpsk.demodulate(
        jnp.asarray(iq[0])))).max() <= 1e-4


# ---- ingest quantizers and trace -----------------------------------------

def test_quantizers_byte_identical():
    rng = np.random.default_rng(33)
    re = rng.normal(0, 0.4, 5000).astype(np.float32)
    im = rng.normal(0, 0.4, 5000).astype(np.float32)
    for a, b in zip(stream.quantize_iq(re, im), j_stream.quantize_iq(re, im)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for scale in (127.0, 50.0):
        qr, qi = j_stream.quantize_iq(re, im, scale)
        got = stream.dequantize_iq(torch.as_tensor(qr), torch.as_tensor(qi))
        want = j_stream.dequantize_iq(qr, qi)
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
    a, b = stream.quantize_iq4(re, im), j_stream.quantize_iq4(re, im)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for g, w in zip(stream.dequantize_iq4(torch.as_tensor(a)),
                    j_stream.dequantize_iq4(b)):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_trace_module(tmp_path):
    """set_level gates taps (tensors and arrays, dumped to tap_dir),
    timer feeds timings, device_trace writes a Chrome trace."""
    from tetra_tpu_torch.utils import trace
    trace.set_level(1)
    trace.tap("x", np.ones(3))
    assert trace.taps("x") == [] and trace.enabled(1) and not trace.enabled(2)
    trace.set_level(2, str(tmp_path))
    try:
        trace.tap("x", torch.arange(3), meta={"k": 1})
        trace.tap("x", np.zeros(2))
        assert [a.tolist() for a, _ in trace.taps("x")] == [[0, 1, 2],
                                                            [0.0, 0.0]]
        assert (tmp_path / "x_1.npy").exists()
    finally:
        trace.clear_taps()
        trace.set_level(0)
    trace.clear_timings()
    with trace.timer("t"):
        pass
    with trace.timer("t"):
        pass
    assert trace.timings()["t"]["n"] == 2
    with trace.device_trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0

