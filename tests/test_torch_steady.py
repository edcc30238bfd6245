"""Steady locked-step slice of the PyTorch port vs tetra_tpu on the CPU,
block level: kernel K5's plain version (the fused hard demod) against
the XLA demod and the Pallas kernel in interpret mode, the burst
splitters, RM(30,14), the per-kind block decoders (kernel K1's plain
version), the broadcast block, the burst decoders, the SYNC fields, the
training-sequence checks and grouped_decode. All bit-exact, except the
8 dB demod case, held to the JAX package's own bound (<= 1e-3 of the
decisions, tests/test_demod_pallas.py)."""
import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import t, n
from tests.test_demod_pallas import _signal as _jax_signal
from tests.test_steady import _mixed_slots, INIT

from tetra_tpu import tx, constants as C
from tetra_tpu.lmac import pipeline as j_pipe, steady as j_steady
from tetra_tpu.ops import rm3014 as j_rm
from tetra_tpu.phy import burst as j_burst, dqpsk as j_dqpsk
from tetra_tpu.phy import demod_pallas as j_dp

from tetra_tpu_torch.lmac import pipeline, steady
from tetra_tpu_torch.ops import rm3014
from tetra_tpu_torch.phy import burst, demod_fused


def _signal(seed, C_, n_sym, snr_db=None, delay=0):
    """tests/test_demod_pallas.py's random-bit baseband, as numpy,
    optionally delayed by whole samples."""
    re, im = (np.asarray(x) for x in
              _jax_signal(np.random.default_rng(seed), C_, n_sym,
                          snr_db=snr_db))
    if delay:
        re = np.pad(re, ((0, 0), (delay, 0)))[:, :-delay]
        im = np.pad(im, ((0, 0), (delay, 0)))[:, :-delay]
    return re, im


def _jax_metric_sums(re, im, sps=2):
    """The JAX demod's per-phase |sin 2θ| over samples t < (T//sps)·sps,
    summed (dqpsk._stream_phasors' score times the symbol count), from
    its own matched filter: [C, sps]."""
    taps = j_dqpsk.rrc_taps(sps)
    fr = j_dqpsk._fir_real(jnp.asarray(re), taps)
    fi = j_dqpsk._fir_real(jnp.asarray(im), taps)
    lr = jnp.pad(fr, ((0, 0), (sps, 0)))[:, :-sps]
    li = jnp.pad(fi, ((0, 0), (sps, 0)))[:, :-sps]
    dr, di = fr * lr + fi * li, fi * lr - fr * li
    n_ = (dr.shape[-1] // sps) * sps
    dr = dr[:, :n_].reshape(dr.shape[0], -1, sps)
    di = di[:, :n_].reshape(di.shape[0], -1, sps)
    s = 2.0 * jnp.abs(dr * di) / (dr * dr + di * di + 1e-12)
    return np.asarray(jnp.sum(s, axis=-2))


@pytest.mark.parametrize("case", ["clean", "timing_offset", "ragged",
                                  "single_block", "snr8", "odd_T",
                                  "one_carrier"])
def test_k5_plain_vs_xla_and_pallas(case):
    """K5's plain version (bits, best, met) == dqpsk.demodulate_hard_ri
    (XLA) and the Pallas kernel in interpret mode: identical bits and
    phase picks, and at 8 dB at most 1e-3 of the decisions differ; met
    equal to the JAX demod's metric sums to f32 rounding. Covers T odd,
    T < 256, T not a multiple of the kernel's 2048-sample tile, C = 1."""
    seed, C_, n_sym, snr, delay, tc, tt = {
        "clean": (11, 5, 700, None, 0, 4, 256),
        "timing_offset": (13, 4, 500, None, 1, 4, 256),
        "ragged": (14, 7, 301, None, 0, 4, 256),
        "single_block": (15, 2, 64, None, 0, 2, 512),
        "snr8": (12, 6, 700, 8.0, 0, 8, 256),
        "odd_T": (17, 3, 301, None, 0, 4, 256),
        "one_carrier": (18, 1, 1500, None, 1, 1, 512)}[case]
    re, im = _signal(seed, C_, n_sym, snr, delay)
    if case == "odd_T":
        re, im = re[:, :-1].copy(), im[:, :-1].copy()
        n_sym -= 1
    bits, best, met = (n(x) for x in demod_fused.demod_fused(t(re), t(im)))
    xla = np.asarray(j_dqpsk.demodulate_hard_ri(jnp.asarray(re),
                                                jnp.asarray(im)))
    pal = np.asarray(j_dp.demodulate_hard_ri_pallas(
        jnp.asarray(re), jnp.asarray(im), tile_c=tc, tile_t=tt,
        interpret=True))
    sel = np.asarray(j_dp._demod_sel(jnp.asarray(re), jnp.asarray(im),
                                     tile_c=tc, tile_t=tt, interpret=True))
    assert bits.shape == xla.shape == (C_, 2 * n_sym)
    if snr is None:
        assert np.array_equal(bits, xla) and np.array_equal(bits, pal)
        assert np.array_equal(sel, bits[:, 0::2] | (bits[:, 1::2] << 1))
    else:
        assert np.mean(bits != xla) <= 1e-3 and np.mean(bits != pal) <= 1e-3
    want = _jax_metric_sums(re, im)
    assert np.array_equal(best, np.argmax(want, axis=-1))
    np.testing.assert_allclose(met, want, rtol=1e-5)
    assert np.array_equal(n(demod_fused.demodulate_hard_ri_pallas(
        t(re), t(im))), bits)


def test_k5_slot_framed_output():
    """demodulate_hard_slots_ri_pallas at phase_bit 64: slots and bits
    equal the Pallas kernel's (interpret mode); odd phase_bit raises."""
    n_slots, phase_bit = 3, 64
    re, im = _signal(16, 5, (phase_bit + n_slots * 510) // 2 + 40)
    slots, bits = demod_fused.demodulate_hard_slots_ri_pallas(
        t(re), t(im), n_slots, phase_bit=phase_bit)
    js, jb = j_dp.demodulate_hard_slots_ri_pallas(
        jnp.asarray(re), jnp.asarray(im), n_slots, phase_bit=phase_bit,
        tile_c=4, tile_t=256, interpret=True)
    assert np.array_equal(n(slots), np.asarray(js))
    assert np.array_equal(n(bits), np.asarray(jb))
    # the slots are a view of the bits: no second write
    assert slots.data_ptr() == bits.data_ptr() + phase_bit
    assert not slots.is_contiguous()
    with pytest.raises(ValueError):
        demod_fused.demodulate_hard_slots_ri_pallas(t(re), t(im), n_slots,
                                                    phase_bit=63)


def test_split_sync_burst():
    x = np.random.default_rng(1).integers(0, 2, (2, 3, 510)).astype(np.int8)
    for a, b in zip(burst.split_sync_burst(t(x)),
                    j_burst.split_sync_burst(jnp.asarray(x))):
        assert np.array_equal(n(a), np.asarray(b))


def test_rm3014_every_word_and_single_errors():
    """encode over all 2^14 words; decode with and without correction on
    every codeword, on single-bit errors at every position (2,000 words
    x 30) and on double-bit errors (uncorrectable)."""
    words = np.arange(1 << 14)
    info = ((words[:, None] >> np.arange(13, -1, -1)) & 1).astype(np.int8)
    cw = n(rm3014.encode(t(info)))
    assert np.array_equal(cw, np.asarray(j_rm.encode(jnp.asarray(info))))
    for v in (0, 1, 0x1234, 0x3FFF):
        assert rm3014.encode_uint(v) == j_rm.encode_uint(v)
    rng = np.random.default_rng(2)
    sub = cw[rng.choice(len(cw), 2000, replace=False)]
    single = np.repeat(sub, 30, axis=0)
    single[np.arange(len(single)), np.tile(np.arange(30), 2000)] ^= 1
    double = sub.copy()
    for row in double:
        row[rng.choice(30, 2, replace=False)] ^= 1
    for x in (cw, single, double):
        for correct in (False, True):
            a = rm3014.decode(t(x), correct=correct)
            b = j_rm.decode(jnp.asarray(x), correct=correct)
            assert np.array_equal(n(a[0]), np.asarray(b[0]))
            assert np.array_equal(n(a[1]), np.asarray(b[1]))


def _encoded_blocks(kind, n_rows, seed):
    """TX-encoded type-5 blocks of random type-1 bits, each row with
    0..n345/6 bit flips, and the scrambling code per row."""
    n345, _, n1, _, _ = C.BLOCK_PARAMS[kind]
    rng = np.random.default_rng(seed)
    t1 = rng.integers(0, 2, (n_rows, n1)).astype(np.int8)
    inits = np.full(n_rows, INIT, np.uint32)
    inits[1::3] = 0x1234567 << 2 | 3
    t5 = np.stack([np.asarray(tx.encode_block(kind, jnp.asarray(t1[i]),
                                              jnp.uint32(inits[i])))
                   for i in range(n_rows)]).astype(np.int8)
    for i in range(n_rows):
        k = int(rng.integers(0, n345 // 6))
        t5[i, rng.choice(n345, k, replace=False)] ^= 1
    return t5, inits


@pytest.mark.parametrize("kind", ["SB1", "SB2", "NDB", "SCH_HU", "SCH_F"])
def test_decode_block(kind):
    """decode_block (K1's plain version at n_sym 80, 144, 112, 288) ==
    the JAX CPU pipeline on TX-encoded blocks with bit flips."""
    t5, inits = _encoded_blocks(kind, 12, {"SB1": 1, "SB2": 2, "NDB": 3,
                                           "SCH_HU": 4, "SCH_F": 5}[kind])
    got = pipeline.decode_block(kind, t(t5), t(inits))
    want = j_pipe.decode_block(kind, jnp.asarray(t5), jnp.asarray(inits))
    for a, b in zip(got, want):
        assert np.array_equal(n(a), np.asarray(b))
    assert n(got.crc_ok).any() and not n(got.crc_ok).all()


@pytest.mark.parametrize("reference_mode", [True, False])
def test_decode_bbk(reference_mode):
    rng = np.random.default_rng(6)
    info = rng.integers(0, 2, (16, 14)).astype(np.int8)
    inits = np.full(16, INIT, np.uint32)
    inits[::4] = 3
    t5 = np.asarray(tx.encode_bbk(jnp.asarray(info),
                                  jnp.asarray(inits))).astype(np.int8)
    for i in range(16):
        t5[i, rng.choice(30, i % 3, replace=False)] ^= 1
    got = pipeline.decode_bbk(t(t5), t(inits), reference_mode)
    want = j_pipe.decode_bbk(jnp.asarray(t5), jnp.asarray(inits),
                             reference_mode)
    for a, b in zip(got, want):
        assert np.array_equal(n(a), np.asarray(b))


@pytest.mark.parametrize("name", ["decode_sync_burst", "decode_ndb_burst",
                                  "decode_schf_burst"])
def test_burst_decoders(name):
    """The three burst decoders on [C, S, 510] mixed slots with bit
    flips and per-carrier codes [C, 1]: every block identical."""
    slots, _, _ = _mixed_slots(n_carriers=2, n_slots=3, seed=4)
    rng = np.random.default_rng(7)
    for s in slots.reshape(-1, 510)[1::2]:
        s[rng.choice(510, 12, replace=False)] ^= 1
    inits = np.asarray([INIT, 3], np.uint32)[:, None]
    got = getattr(pipeline, name)(t(slots), t(inits))
    want = getattr(j_pipe, name)(jnp.asarray(slots), jnp.asarray(inits))
    assert got.keys() == want.keys()
    for key in want:
        for a, b in zip(got[key], want[key]):
            assert np.array_equal(n(a), np.asarray(b)), key


def test_sb1_sync_fields():
    t1 = np.random.default_rng(8).integers(0, 2, (9, 60)).astype(np.int8)
    got = pipeline.sb1_sync_fields(t(t1))
    want = j_pipe.sb1_sync_fields(jnp.asarray(t1))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(n(got[k]), np.asarray(want[k]).astype(np.int64))


def test_train_seq_checks():
    """verify_train_seq and classify_train_seq on mixed slots with 0..6
    flipped training bits (and random slots)."""
    slots, _, _ = _mixed_slots(n_carriers=3, n_slots=6, seed=5)
    rng = np.random.default_rng(9)
    flat = slots.reshape(-1, 510)
    for i, s in enumerate(flat):
        lo = C.SYNC_TRAIN_OFFSET if i % 2 else C.NORM_TRAIN_OFFSET
        s[lo + rng.choice(22, i % 7, replace=False)] ^= 1
    flat[-1] = rng.integers(0, 2, 510)
    for fn in ("verify_train_seq", "classify_train_seq"):
        got = n(getattr(steady, fn)(t(slots)))
        want = np.asarray(getattr(j_steady, fn)(jnp.asarray(slots)))
        assert np.array_equal(got, want), fn
    assert (got == -1).any()


def test_grouped_decode():
    slots, _, _ = _mixed_slots(n_carriers=3, n_slots=5, seed=9)
    flat = slots.reshape(-1, 510)
    flat[4, 300:320] ^= 1
    kinds = np.asarray(j_steady.verify_train_seq(jnp.asarray(flat)))
    inits = np.full(len(flat), INIT, np.uint32)
    got = steady.grouped_decode(flat, inits, kinds, device="cpu")
    want = j_steady.grouped_decode(flat, inits, kinds)
    assert got.keys() == want.keys()
    for name in want:
        assert np.array_equal(got[name][0], want[name][0])
        for blk in want[name][1]:
            for a, b in zip(got[name][1][blk], want[name][1][blk]):
                assert np.array_equal(a, np.asarray(b)), (name, blk)
