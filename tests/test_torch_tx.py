"""Transmitter and encoders of the PyTorch port vs tetra_tpu on the CPU:
the mother encoder, puncturing, interleavers, scrambling-code bits,
CRC16 and FCS-32, the TCH/S encoder and reordering, block and burst
encoders, phase-adjustment bits, the training-sequence matcher and
finder, the self-test CLI and the steady fixture rebuilt by the port's
own TX chain. Every output is compared bit for bit."""
import io
import contextlib
import subprocess
import sys
import pathlib

import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import t, n

from tetra_tpu import constants as C, selftest as j_selftest, tx as j_tx
from tetra_tpu import testpdu as j_testpdu
from tetra_tpu.ops import acelp as j_acelp, crc as j_crc
from tetra_tpu.ops import interleave as j_il, rcpc as j_rcpc
from tetra_tpu.ops import scramble as j_scr
from tetra_tpu.phy import burst as j_burst

from tetra_tpu_torch import selftest, steady_fixture, testpdu, tx
from tetra_tpu_torch.ops import acelp, crc, interleave, rcpc, scramble
from tetra_tpu_torch.phy import burst

ROOT = pathlib.Path(__file__).resolve().parent.parent
INIT = j_scr.scramb_get_init(262, 42, 1)
CRC_KINDS = [k for k, v in C.BLOCK_PARAMS.items() if v[4]]


def _bits(seed, *shape):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int8)


def _eq(a, b):
    a, b = n(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("gen", ["CCH", "TCH"])
def test_conv_encode(gen):
    g = getattr(C, f"CONV_GENERATORS_{gen}")
    x = _bits(1, 3, 5, 292)
    _eq(rcpc.conv_encode(t(x), g), j_rcpc.conv_encode(jnp.asarray(x), g))


@pytest.mark.parametrize("cfg", j_selftest.PUNCT_CONFIGS,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_puncture_depuncture(cfg):
    scheme, t2, t3, rate = cfg
    mother = _bits(t2, 4, t2 * rate)
    p = rcpc.puncture(scheme, t(mother), t3)
    jp = j_rcpc.puncture(scheme, jnp.asarray(mother), t3)
    _eq(p, jp)
    _eq(rcpc.depuncture_hard(scheme, p, t2 * rate),
        j_rcpc.depuncture_hard(scheme, jp, t2 * rate))
    assert selftest.PUNCT_CONFIGS == j_selftest.PUNCT_CONFIGS


@pytest.mark.parametrize("K,a", [(120, 11), (216, 101), (432, 103),
                                 (168, 13)])
def test_block_interleave(K, a):
    x = _bits(K, 6, K)
    _eq(interleave.block_interleave(K, a, t(x)),
        j_il.block_interleave(K, a, jnp.asarray(x)))
    _eq(interleave.block_deinterleave(K, a, t(x)),
        j_il.block_deinterleave(K, a, jnp.asarray(x)))
    assert np.array_equal(interleave.matrix_interleave_indices(24, K // 24),
                          j_il.matrix_interleave_indices(24, K // 24))


def test_init_to_bits():
    inits = np.asarray([0, 3, INIT, 0xFFFFFFFF, 0x80000001], np.uint32)
    _eq(scramble.init_to_bits(t(inits)), j_scr.init_to_bits(jnp.asarray(inits)))
    _eq(scramble.init_to_bits(INIT), j_scr.init_to_bits(INIT))


@pytest.mark.parametrize("L", [14, 31, 60, 268, 300])
def test_crc16_and_fcs32(L):
    x = _bits(L, 7, L)
    _eq(crc.crc16_bits(t(x)), j_crc.crc16_bits(jnp.asarray(x)))
    _eq(crc.crc16_value(t(x)), j_crc.crc16_value(jnp.asarray(x)))
    _eq(crc.crc16_check(t(x)), j_crc.crc16_check(jnp.asarray(x)))
    _eq(crc.fcs32(t(x)), j_crc.fcs32(jnp.asarray(x)))
    M, Cc = crc.fcs32_matrix(L)
    Mj, Cj = j_crc.fcs32_matrix(L)
    assert np.array_equal(M, Mj) and np.array_equal(Cc, Cj)


def test_tch_s_encode_and_reorder():
    c0, c1, c2 = _bits(2, 5, 102), _bits(3, 5, 108), _bits(4, 5, 64)
    _eq(acelp.tch_s_encode(t(c0), t(c1), t(c2)),
        j_acelp.tch_s_encode(jnp.asarray(c0), jnp.asarray(c1),
                             jnp.asarray(c2)))
    x = _bits(5, 5, 274)
    _eq(acelp.codec_to_type2(t(x)), j_acelp.codec_to_type2(jnp.asarray(x)))
    # the decode side inverts the encode side on every mapped bit
    back = acelp.type2_to_codec(acelp.codec_to_type2(t(x)))
    _eq(back, j_acelp.type2_to_codec(j_acelp.codec_to_type2(jnp.asarray(x))))


@pytest.mark.parametrize("kind", CRC_KINDS)
def test_encode_block(kind):
    n1 = C.BLOCK_PARAMS[kind][2]
    x = _bits(n1, 9, n1)
    inits = np.full(9, INIT, np.uint32)
    inits[1::3] = 0x1234567 << 2 | 3
    _eq(tx.encode_block(kind, t(x), t(inits)[:, None][:, 0]),
        j_tx.encode_block(kind, jnp.asarray(x), jnp.asarray(inits)))
    _eq(tx.encode_block(kind, x[0], INIT, device="cpu"),
        j_tx.encode_block(kind, jnp.asarray(x[0]), jnp.uint32(INIT)))
    _eq(tx.append_crc_tail(t(x)), j_tx.append_crc_tail(jnp.asarray(x)))


def test_encode_bbk_and_no_bbk_block():
    x = _bits(14, 16, 14)
    inits = np.full(16, INIT, np.uint32)
    inits[::4] = 3
    _eq(tx.encode_bbk(t(x), t(inits)), j_tx.encode_bbk(jnp.asarray(x),
                                                       jnp.asarray(inits)))
    with pytest.raises(ValueError):
        tx.encode_block("BBK", t(x), INIT)
    with pytest.raises(AssertionError):
        j_tx.encode_block("BBK", jnp.asarray(x), jnp.uint32(INIT))


@pytest.mark.parametrize("which", ["sync", "schf", "ndb"])
def test_make_bursts(which):
    """Each burst builder on 6 random PDU sets (random codes, too)."""
    rng = np.random.default_rng({"sync": 1, "schf": 2, "ndb": 3}[which])
    for _ in range(6):
        init = int(rng.integers(0, 1 << 30)) << 2 | 3
        aa = rng.integers(0, 2, 14).astype(np.int8)
        if which == "sync":
            args = (rng.integers(0, 2, 60).astype(np.int8),
                    rng.integers(0, 2, 124).astype(np.int8), aa)
        elif which == "schf":
            args = (rng.integers(0, 2, 268).astype(np.int8), aa)
        else:
            args = (rng.integers(0, 2, 124).astype(np.int8),
                    rng.integers(0, 2, 124).astype(np.int8), aa)
        got = getattr(tx, f"make_{which}_burst")(*args, init, device="cpu")
        want = getattr(j_tx, f"make_{which}_burst")(
            *(jnp.asarray(a) for a in args), jnp.uint32(init))
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_make_schf_bursts_batched():
    """The batched device builder equals the per-burst numpy builder."""
    x, aa = _bits(21, 40, 268), _bits(22, 40, 14)
    got = n(tx.make_schf_bursts(t(x), t(aa), INIT))
    want = np.stack([j_tx.make_schf_burst(jnp.asarray(x[i]),
                                          jnp.asarray(aa[i]),
                                          jnp.uint32(INIT))
                     for i in range(len(x))])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("which", ["HA", "HB", "HC", "HD", "HE", "HF", "HG",
                                   "HH", "HI", "HJ"])
def test_phase_adj_bits(which):
    rng = np.random.default_rng(len(which) + ord(which[1]))
    for _ in range(8):
        b = rng.integers(0, 2, 510).astype(np.uint8)
        assert np.array_equal(burst.phase_adj_bits(b, which),
                              j_burst.phase_adj_bits(b, which))
        assert burst.sum_up_phase(b) == j_burst.sum_up_phase(b)


def _stream(seed: int, n_slots: int = 8):
    """Random slots of every kind, every other one after some garbage
    (back-to-back bursts hold a whole q sequence across their edge), and
    an extended training sequence x."""
    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, 2, 17), C.TRAIN_X]
    for s in range(n_slots):
        parts.append(rng.integers(0, 2, int(rng.integers(0, 40)) * (s % 2)))
        init = INIT
        aa = j_testpdu.make_access_assign_bits(hdr=s % 4)
        if s % 3 == 0:
            b = j_tx.make_sync_burst(j_testpdu.make_sync_pdu(),
                                     j_testpdu.make_sysinfo_pdu(), aa,
                                     jnp.uint32(init))
        elif s % 3 == 1:
            b = j_tx.make_schf_burst(j_testpdu.make_resource_pdu(ssi=s), aa,
                                     jnp.uint32(init))
        else:
            b = j_tx.make_ndb_burst(rng.integers(0, 2, 124),
                                    rng.integers(0, 2, 124), aa,
                                    jnp.uint32(init))
        parts.append(b)
    return np.concatenate(parts).astype(np.int8)


@pytest.mark.parametrize("tol", [0, 2])
@pytest.mark.parametrize("mask", [0x1F, 0x0B, 0x14])
def test_train_seq_match_full_mask(mask, tol):
    L = 3000
    bits = np.stack([_stream(s)[:L] for s in range(3)])
    bits[1, 500:520] ^= 1
    got = n(burst.train_seq_match(t(bits), mask, tol))
    want = np.asarray(j_burst.train_seq_match(jnp.asarray(bits), mask, tol))
    assert got.shape == want.shape == (3, L, 5)
    assert np.array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("mask", [0x1F, 0x01, 0x08, 0x10])
def test_find_train_seq(mask):
    """On streams, on windows with no hit and on 3-d batches."""
    rng = np.random.default_rng(mask)
    rows = [_stream(s)[:1500] for s in range(4)]
    rows.append(rng.integers(0, 2, 1500).astype(np.int8))
    rows.append(np.zeros(1500, np.int8))
    bits = np.stack(rows)
    for x in (bits, bits.reshape(2, 3, 1500), bits[:, 200:260]):
        got = burst.find_train_seq(t(x), mask)
        want = j_burst.find_train_seq(jnp.asarray(x), mask)
        for a, b in zip(got, want):
            _eq(a, b)


def test_testpdu_copy():
    for name in ("make_sync_pdu", "make_sysinfo_pdu",
                 "make_access_assign_bits", "make_resource_pdu",
                 "make_mle_cmce_dsetup"):
        assert np.array_equal(getattr(testpdu, name)(),
                              getattr(j_testpdu, name)())


@pytest.mark.parametrize("argv", [["--device", "cpu"]])
def test_selftest_main_matches_jax_cli(argv):
    """The port's CLI prints the JAX CLI's stdout and exit code."""
    outs = []
    for mod, args in ((selftest, argv), (j_selftest, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
            mod.main(args)
        outs.append((buf.getvalue(), e.value.code))
    assert outs[0] == outs[1]
    assert outs[0][1] == 0 and outs[0][0].count("==> Puncture/Depuncture") == 9
    assert outs[0][0].endswith("total number of CRC Errors: 0\n")


def test_selftest_subprocess_and_soak():
    out = subprocess.run([sys.executable, "-m", "tetra_tpu_torch.selftest",
                          "--device", "cpu"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "total number of CRC Errors: 0"
    assert selftest.loopback_soak(32, seed=7, device="cpu") == \
        j_selftest.loopback_soak(32, seed=7) == 0


def test_steady_fixture_rebuilt_by_port_tx():
    fx = steady_fixture.load()
    slots, kinds, pay, init = steady_fixture.tx_slots(device="cpu")
    assert np.array_equal(slots, fx["slots"]) and init == fx["init"]
    assert np.array_equal(kinds, fx["kinds"])
    for k, v in pay.items():
        assert np.array_equal(fx[k], v), k
