"""The soft-decision wideband path of the PyTorch port (demod="soft")
vs tetra_tpu on the CPU: the plain version of kernel K4 (f32 segmented
Viterbi), the soft demod, the 2-bit-tolerant sync scan, the soft fused
decode and the receiver end to end, plus the jax-free snr8 fixture."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import CPU, t, n
from tests.test_fused import _mixed_slots, INIT
from tests.test_sync_vec import make_stream

from tetra_tpu.lmac import fused as j_fused
from tetra_tpu.ops.viterbi_pallas import decode_segmented_pallas
from tetra_tpu.phy import burst as j_burst, sync_vec as j_sv

from tetra_tpu_torch.lmac import fused
from tetra_tpu_torch.ops.viterbi_segmented import decode_segmented_k4
from tetra_tpu_torch.phy import burst
from tetra_tpu_torch.phy.sync_vec import sync_scan, OUT_KEYS

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _soft_rows(kind: str, B: int, seed: int):
    """[B, 1152] f32 soft rows and [B, 3] restart masks. "int": the soft
    path's alphabet (int8 soft values x 127, |v| <= 124*127) with ~3/8
    erasures; "dyadic": multiples of 0.25 in [-2, 2] (f32 sums exact in
    both packages)."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        v = rng.integers(-124, 125, (B, fused.N_MOTHER)) * 127
        v[rng.random((B, fused.N_MOTHER)) < 0.375] = 0
    else:
        v = rng.integers(-8, 9, (B, fused.N_MOTHER)) * 0.25
    rm = rng.integers(0, 2, (B, len(fused.BOUNDARIES)))
    return v.astype(np.float32), rm.astype(np.int8)


@pytest.mark.parametrize("kind", ["int", "dyadic"])
def test_k4_plain_vs_xla_scan(kind):
    """K4's plain version == tetra_tpu.lmac.fused.decode_segmented, bit
    for bit. The dyadic case fails where the plain Viterbi truncates
    float soft values to integers."""
    soft, rm = _soft_rows(kind, 64, 11 if kind == "int" else 12)
    want = np.asarray(j_fused.decode_segmented(jnp.asarray(soft),
                                               jnp.asarray(rm, jnp.float32)))
    got = n(decode_segmented_k4(t(soft), t(rm), fused.N_SYM,
                                fused.BOUNDARIES))
    assert got.dtype == np.int8 and np.array_equal(got, want)


def test_k4_plain_vs_pallas_interpret():
    """K4's plain version == decode_segmented_pallas (f32 input: the
    radix-16 body with the compare+min tie-break) in interpret mode."""
    soft, rm = _soft_rows("int", 16, 13)
    soft[:4] = np.sign(soft[:4]) * 127       # tie-rich rows
    want = np.asarray(decode_segmented_pallas(
        jnp.asarray(soft), jnp.asarray(rm, jnp.float32), fused.N_SYM,
        fused.BOUNDARIES, tile_b=8, interpret=True))
    got = n(decode_segmented_k4(t(soft), t(rm), fused.N_SYM,
                                fused.BOUNDARIES))
    assert np.array_equal(got, want)


def test_k4_plain_short_unsegmented():
    """n_sym 80 with no boundaries (the CPU-test shape the card also
    checks): == the XLA scan."""
    soft, _ = _soft_rows("int", 32, 14)
    soft = soft[:, :320]
    rm = np.zeros((32, 0), np.int8)
    want = np.asarray(j_fused.decode_segmented(
        jnp.asarray(soft), jnp.zeros((32, 0), jnp.float32), 80, ()))
    got = n(decode_segmented_k4(t(soft), t(rm), 80, ()))
    assert np.array_equal(got, want)


# ---- demod, tolerant sync, soft fused decode ------------------------------

def _wide_capture_8db():
    from tests.test_fastpath_soft import (_awgn_wide, _wide_capture, CHANS,
                                          N_CHAN)
    return _awgn_wide(_wide_capture(), 8.0, len(CHANS)), CHANS, N_CHAN


def test_demod_soft_vs_jax():
    """demodulate_soft_ri(os=4) on the 8 dB 8-channel PFB capture of
    test_fastpath_soft, both fed the same channelized planes: identical
    signs; values may differ by 1 (f32 filter rounding at a .5 step of
    round(x*31)) in at most 1e-4 of positions."""
    from tetra_tpu.phy import dqpsk as j_dqpsk, pfb as j_pfb
    from tetra_tpu_torch.phy import dqpsk
    wide, chans, n_chan = _wide_capture_8db()
    cr, ci = j_pfb.pfb_to_demod_rate_ri(
        jnp.asarray(wide.real), jnp.asarray(wide.imag),
        jnp.asarray(chans, jnp.int32), n_chan, n_chan * 25e3)
    cr, ci = np.asarray(cr), np.asarray(ci)
    want = np.asarray(j_dqpsk.demodulate_soft_ri(jnp.asarray(cr),
                                                 jnp.asarray(ci), sps=2,
                                                 os=4))
    got = n(dqpsk.demodulate_soft_ri(t(cr), t(ci), sps=2, os=4))
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(np.sign(got), np.sign(want))
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (d.max(), (d > 0).mean())
    assert np.abs(want).max() > 31 and (want == 0).mean() < 0.05


def _corrupted_streams(B: int = 6, seed: int = 20):
    """test_sync_vec streams with extra 1-2 bit errors inside training
    sequences, where tolerance changes the decisions."""
    streams = [make_stream(seed + b, n_frames=3) for b in range(B)]
    L = min(len(s) for s in streams)
    bits = np.stack([s[:L] for s in streams]).astype(np.int8)
    rng = np.random.default_rng(seed)
    hits = np.argwhere(np.asarray(j_burst.train_seq_match(
        jnp.asarray(bits), j_sv._MASK))[..., :3].any(-1))
    for b, q in hits[rng.random(len(hits)) < 0.5]:
        bits[b, q + rng.choice(22, int(rng.integers(1, 3)), replace=False)] ^= 1
    return bits


def test_train_seq_match_tolerant():
    bits = _corrupted_streams()
    want = np.asarray(j_burst.train_seq_match(jnp.asarray(bits), j_sv._MASK,
                                              tol=2))
    got = n(burst.train_seq_match(t(bits), j_sv._MASK, tol=2))
    assert np.array_equal(got, want)
    assert got.sum() > n(burst.train_seq_match(t(bits), j_sv._MASK)).sum()


@pytest.mark.parametrize("chunks", [1, 3])
def test_sync_scan_tolerant(chunks):
    """sync_scan(tol=2) == tetra_tpu's on corrupted streams, every
    OUT_KEYS output and the carry, whole and in uneven chunks."""
    bits = _corrupted_streams(seed=30 + chunks)
    B, L = bits.shape
    total = (L - 64 * 10) // 64
    cuts = [total] if chunks == 1 else [17, 40, total - 57]
    z = np.zeros(B, np.int32)
    jc = (z,) * 5
    tc = tuple(t(z) for _ in range(5))
    fed = 0
    emitted = 0
    for steps in cuts:
        (js, jb, jn, jf, ji, jfed), jout = j_sv.sync_scan(
            jnp.asarray(bits), *map(jnp.asarray, jc), np.int32(fed), steps,
            tol=2)
        (ts, tb, tn, tf, ti, tfed), tout = sync_scan(t(bits), *tc, fed,
                                                     steps, tol=2)
        for k in OUT_KEYS:
            assert np.array_equal(n(tout[k]), np.asarray(jout[k])), k
        for a, b in zip((ts, tb, tn, tf, ti), (js, jb, jn, jf, ji)):
            assert np.array_equal(n(a), np.asarray(b))
        emitted += int(n(tout["emit"]).sum())
        jc = (js, jb, jn, jf, ji * 0)
        tc = (ts, tb, tn, tf, ti * 0)
        fed = tfed
    assert emitted > 0


def _soft_slots(n_slots: int, seed: int, snr_db: float = 8.0):
    """Mixed-kind slots as int8-alphabet soft values: ±31 plus Gaussian
    noise at snr_db (per bit), rounded and clipped at ±124."""
    slots, kinds = _mixed_slots(n=n_slots, seed=seed)
    rng = np.random.default_rng(seed)
    sigma = 31.0 / np.sqrt(10 ** (snr_db / 10))
    soft = (1 - 2 * slots.astype(np.float64)) * 31.0 \
        + rng.normal(0, sigma, slots.shape)
    return np.clip(np.round(soft), -124, 124).astype(np.float32), kinds


@pytest.mark.parametrize("snr_db", [8.0, 3.0])
def test_decode_slots_fused_soft(snr_db):
    """decode_slots_fused(soft_input=True) == tetra_tpu's: every block's
    bits and crc_ok flag, with per-slot codes and a kind -1 slot."""
    soft, kinds = _soft_slots(15, int(snr_db), snr_db)
    kinds[4] = -1
    inits = np.full(len(soft), INIT, np.uint32)
    inits[::5] = 3
    got = fused.decode_slots_fused(t(soft), t(inits), t(kinds),
                                   soft_input=True)
    want = j_fused.decode_slots_fused(jnp.asarray(soft), jnp.asarray(inits),
                                      jnp.asarray(kinds), soft_input=True)
    assert np.array_equal(n(got["crc_ok"]), np.asarray(want["crc_ok"]))
    for key in ("sb1", "sb2", "schf", "ndb1", "ndb2", "bbk"):
        for a, b in zip(got[key], want[key]):
            assert np.array_equal(n(a), np.asarray(b)), key
    if snr_db == 8.0:     # all but the wrong-code slots 0, 5, 10 and 4
        assert n(got["crc_ok"]).sum() == 11


def test_assemble_soft_is_the_spread_matmul():
    """The soft assembly gather equals tetra_tpu's one-hot spread matmul
    on dyadic soft values (every product exact)."""
    slots, kinds = _mixed_slots(n=9, seed=3)
    rng = np.random.default_rng(3)
    soft = ((1 - 2 * slots.astype(np.float32))
            * rng.integers(1, 9, slots.shape) * 0.25).astype(np.float32)
    soft[:, ::7] = 0
    inits = np.full(len(slots), INIT, np.uint32)
    want, jrm, _ = j_fused.assemble_soft(jnp.asarray(soft), jnp.asarray(inits),
                                         jnp.asarray(kinds), soft_input=True)
    got, rm, _ = fused.assemble_soft(t(soft), t(inits.astype(np.int64)),
                                     t(kinds), fused.fused_tables(CPU))
    assert np.array_equal(n(got), np.asarray(want))
    assert np.array_equal(n(rm), np.asarray(jrm))


# ---- the slice: MultiCarrierReceiver(demod="soft") -----------------------

def _receivers(wide, demod: str, cuts=None):
    """The test_fastpath_soft capture through the JAX receiver and the
    port's, fed the same process_iq calls."""
    from tests.test_fastpath_soft import CHANS, N_CHAN
    from tetra_tpu.rx_multi import MultiCarrierReceiver as JaxReceiver
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    kw = dict(fs=N_CHAN * 25e3, pfb_channels=CHANS, n_chan=N_CHAN,
              control_plane="native", demod=demod)
    ref = JaxReceiver([], **kw)
    got = MultiCarrierReceiver([], device=CPU, **kw)
    edges = [0] + (cuts or []) + [len(wide)]
    for rx in (ref, got):
        for i in range(len(edges) - 1):
            rx.process_iq(wide[edges[i]:edges[i + 1]],
                          final=i == len(edges) - 2)
    return ref, got


def _events(mrx):
    return {k: np.concatenate([e[k] for e in mrx.native_events])
            for k in ("carrier", "kind", "a", "b", "c", "d", "payload")}


def test_soft_receiver_clean_matches_jax_and_hard():
    """Clean capture: the soft receiver equals the JAX soft receiver, and
    its events equal the port's hard receiver's (soft signs == hard
    slices, the tolerant scan finds the same exact matches)."""
    from tests.test_fastpath_soft import _wide_capture
    from tests.test_torch_rx_multi import _same_receivers
    wide = _wide_capture()
    ref, got = _receivers(wide, "soft")
    _same_receivers(ref, got, 2)
    _, hard = _receivers(wide, "hard")
    eh, es = _events(hard), _events(got)
    assert all(np.array_equal(eh[k], es[k]) for k in eh)
    assert all(c.stats.crc_ok > 0 for c in got.carriers)


def test_soft_receiver_8db_matches_jax():
    """8 dB per-channel SNR: identical stats and events, and the full
    decode the JAX package's test pins (no CRC errors)."""
    from tests.test_torch_rx_multi import _same_receivers
    wide, _, _ = _wide_capture_8db()
    ref, got = _receivers(wide, "soft")
    _same_receivers(ref, got, 2)
    assert sum(c.stats.crc_wrong for c in got.carriers) == 0
    assert all(c.stats.crc_ok > 0 for c in got.carriers)


def test_soft_receiver_chunked_matches_jax_and_whole():
    """9 dB capture in 3 uneven chunks (the cuts of test_fastpath_soft):
    the port equals the JAX receiver on the same cuts and its own
    one-call run."""
    from tests.test_fastpath_soft import _awgn_wide, _wide_capture, CHANS, \
        N_CHAN
    from tests.test_torch_rx_multi import _same_receivers
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    wide = _awgn_wide(_wide_capture(), 9.0, len(CHANS), seed=5)
    blk = 25 * N_CHAN
    ref, got = _receivers(wide, "soft", cuts=[7 * blk, 13 * blk + 41])
    _same_receivers(ref, got, 2)
    whole = MultiCarrierReceiver([], fs=N_CHAN * 25e3, pfb_channels=CHANS,
                                 n_chan=N_CHAN, control_plane="native",
                                 demod="soft", device=CPU)
    whole.process_iq(wide, final=True)
    ew, ec = _events(whole), _events(got)
    assert all(np.array_equal(ew[k], ec[k]) for k in ew)


def test_hard_bits_through_soft_pipeline():
    """process_bits on a soft pipeline (hard bits -> ±31): with tol=0 the
    events equal the hard pipeline's; with the default tol=2 they equal
    the JAX soft receiver's."""
    from tests.test_torch_rx_multi import _same_receivers
    from tetra_tpu.rx_multi import MultiCarrierReceiver as JaxReceiver
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    streams = [make_stream(4100 + b, n_frames=3) for b in range(4)]
    L = min(len(s) for s in streams)
    bits = np.stack([s[:L] for s in streams])

    def port(demod, tol=None):
        m = MultiCarrierReceiver([], fs=1e5, pfb_channels=np.arange(4),
                                 control_plane="native", demod=demod,
                                 device=CPU)
        if tol is not None:
            m._fast.tol = tol
        m.process_bits(bits, final=True)
        return m

    hard, soft0 = port("hard"), port("soft", tol=0)
    eh, es = _events(hard), _events(soft0)
    assert all(np.array_equal(eh[k], es[k]) for k in eh)
    ref = JaxReceiver(np.zeros(4), fs=1e5, control_plane="native",
                      demod="soft")
    ref.process_bits(bits, final=True)
    soft2 = port("soft")
    _same_receivers(ref, soft2, 4)
    assert sum(c.stats.crc_ok for c in soft2.carriers) \
        >= sum(c.stats.crc_ok for c in hard.carriers) > 0


def test_bad_demod_raises():
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    with pytest.raises(ValueError):
        MultiCarrierReceiver([], fs=2e5, pfb_channels=np.arange(8),
                             n_chan=8, control_plane="native",
                             demod="slotwise", device=CPU)


# ---- jax-free run and the snr8 fixture -----------------------------------

def test_soft_slice_is_jax_free():
    """A fresh interpreter rebuilds a small noisy snr8 capture from the
    fixture and decodes it with the soft receiver, never loading jax."""
    code = """
import sys
import numpy as np
from tetra_tpu_torch import prod_fixture
from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
packed = prod_fixture.snr8_capture(8)
mrx = MultiCarrierReceiver([], fs=2e5, pfb_channels=np.arange(8), n_chan=8,
                           control_plane="native", demod="soft", device="cpu")
stats = mrx.process_iq4c(packed)
assert sum(s.crc_ok for s in stats) > 8 * 60, [s.crc_ok for s in stats]
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_snr8_capture_equals_bench(monkeypatch):
    """prod_fixture.snr8_capture(16) == the capture bench_mc_e2e's
    _wideband_pass builds for run_snr8 at 16 carriers, byte for byte
    (the receiver and the timing loop are stubbed out to record it)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import bench_mc_e2e as B
    from tetra_tpu_torch import prod_fixture

    chunks = []

    class Recorder:
        def __init__(self, *a, **kw):
            assert kw["demod"] == "soft"

        def process_iq4c(self, packed, final=True):
            chunks.append(np.asarray(packed))
            return []

    monkeypatch.setattr(B, "MultiCarrierReceiver", Recorder)
    monkeypatch.setattr(B, "timed_passes", lambda one_pass: (*one_pass(), 0.0))
    rng = np.random.default_rng(0)
    row = B.make_stream(rng, 16)
    n_tail = B.common_len(16) - len(row)
    row = B.circular_safe_pad(row, rng, n_tail)
    bits = np.tile(row, (16, 1))
    rolls = B.safe_rolls(16, bits.shape[1], n_tail)
    for c in range(16):
        bits[c] = np.roll(bits[c], rolls[c])
    B._wideband_pass(bits, 16, 4, snr_db=8.0, demod="soft")
    want = np.concatenate(chunks)
    fx = prod_fixture.load_snr8()
    assert np.array_equal(prod_fixture.snr8_bits(16, fx), bits)
    got = prod_fixture.snr8_capture(16, fx)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert int(fx["snr8_crc_ok"]) == 74_343


def test_snr8_fixture_holds_jax_soft_record():
    """The snr8 fixture stores the JAX soft path's per-carrier stats
    (make_torch_fixture.soft_parity) on the 16 carriers the tool names:
    10 from the port's worst lists and the PFB's edges and centre, each
    with bursts and CRC-OK blocks of a decoded 8 dB carrier."""
    sys.path.insert(0, str(ROOT / "tools"))
    import make_torch_fixture as M
    from tetra_tpu_torch import prod_fixture
    rec = prod_fixture.soft_record(prod_fixture.load_snr8())
    assert tuple(rec) == M.SNR8_PARITY_CHANNELS and len(set(rec)) == 16
    assert {0, 1, 511, 512, 1022, 1023} <= set(rec)
    st = np.asarray(list(rec.values()))
    assert st.shape == (16, 3) and (st[:, :2] > 40).all()
    assert (st[:, 1] <= 80).all() and (st[:, 2] <= 3).all()
