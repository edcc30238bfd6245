"""FEC of the PyTorch port vs tetra_tpu on the CPU: scrambling, CRC16,
the plain version of kernel K1 (assembly gather + segmented Viterbi +
CRC), the SB1 decode and the fused mixed-kind decode — all bit-exact."""
import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import t, n
from tests.test_fused import _mixed_slots, INIT

from tetra_tpu.ops import crc as j_crc, scramble as j_scr
from tetra_tpu.lmac import fused as j_fused, pipeline as j_pipe
from tetra_tpu.ops.viterbi_pallas import decode_assembled_pallas

from tetra_tpu_torch.ops import crc, scramble
from tetra_tpu_torch.ops.viterbi_assembled import decode_assembled
from tetra_tpu_torch.lmac import fused, pipeline


def test_keystream_and_scramb_bits():
    inits = np.asarray([3, INIT, 0xFFFFFFFF, 0x12345677], np.uint32)
    got = n(scramble.keystream(t(inits), 432))
    assert np.array_equal(got, np.asarray(j_scr.keystream(
        jnp.asarray(inits), 432)))
    bits = np.random.default_rng(0).integers(0, 2, (4, 216)).astype(np.int8)
    assert np.array_equal(
        n(scramble.scramb_bits(t(inits)[:, None], t(bits))),
        np.asarray(j_scr.scramb_bits(jnp.asarray(inits)[:, None],
                                     jnp.asarray(bits))))


def test_crc16_check():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (64, 284)).astype(np.int8)
    bits[0] = 0
    assert np.array_equal(n(crc.crc16_check(t(bits))),
                          np.asarray(j_crc.crc16_check(jnp.asarray(bits))))


def _port_fused(slots, inits, kinds):
    tables = fused.fused_tables(t(slots).device)
    x, tab, rm, _ = fused.assemble_parts(
        t(slots, None), t(np.broadcast_to(inits, kinds.shape)),
        t(kinds), tables)
    return decode_assembled(x, tables.code.pidx, tab, rm, tables.code.crcw,
                            tables.code.crct, fused.N_SYM, fused.BOUNDARIES,
                            fused.CRC_SEGS)


@pytest.mark.parametrize("nflip", [0, 3, 20, 120])
def test_k1_plain_vs_segmented_scan(nflip):
    """K1's plain version == fused.decode_segmented + crc16_check per
    segment on the (corrupted) mixed-kind batches of test_fused."""
    slots, kinds = _mixed_slots(n=12, seed=nflip, corrupt=nflip)
    inits = np.full(len(slots), INIT, np.uint32)
    soft, rm, _ = j_fused.assemble_soft(jnp.asarray(slots, jnp.int8),
                                        jnp.asarray(inits),
                                        jnp.asarray(kinds))
    bits_ref = np.asarray(j_fused.decode_segmented(soft, rm))
    ok_ref = np.stack([np.asarray(j_crc.crc16_check(
        jnp.asarray(bits_ref[:, o:o + ln]))) for o, ln in j_fused.CRC_SEGS],
        axis=1)
    bits, ok = _port_fused(slots, inits, kinds)
    assert np.array_equal(n(bits), bits_ref)
    assert np.array_equal(n(ok) != 0, ok_ref)
    if nflip == 0:
        assert ok_ref.any()


def test_k1_plain_vs_pallas_interpret():
    """K1's plain version == decode_assembled_pallas(interpret=True)."""
    slots, kinds = _mixed_slots(n=16, seed=5, corrupt=8)
    slots[3, 100:140] ^= 1
    inits = np.full(len(slots), INIT, np.uint32)
    x, P_np, _, rm, _ = j_fused.assemble_parts(
        jnp.asarray(slots, jnp.int8), jnp.asarray(inits), jnp.asarray(kinds))
    jb, jok = decode_assembled_pallas(
        jnp.transpose(x).astype(jnp.int8), rm,
        np.ascontiguousarray(P_np.T.astype(np.int8)), j_fused.N_SYM,
        j_fused.BOUNDARIES, j_fused.CRC_SEGS, tile_b=16, interpret=True)
    bits, ok = _port_fused(slots, inits, kinds)
    assert np.array_equal(n(bits), np.asarray(jb))
    assert np.array_equal(n(ok), np.asarray(jok))


def test_sb1_decode_block():
    """SB1 (n_sym = 80, no restarts, one CRC segment) == the JAX CPU
    pipeline.decode_block('SB1') on clean and corrupted blocks."""
    slots, kinds = _mixed_slots(n=24, seed=2, corrupt=0)
    t5 = slots[:, 94:214].copy()
    rng = np.random.default_rng(4)
    for i in range(1, 24, 2):
        t5[i, rng.choice(120, size=int(rng.integers(1, 30)),
                         replace=False)] ^= 1
    got = pipeline.decode_block("SB1", t(t5), 0)
    want = j_pipe.decode_block("SB1", jnp.asarray(t5), jnp.uint32(0))
    for a, b in zip(got, want):
        assert np.array_equal(n(a), np.asarray(b))
    assert n(got.crc_ok).any() and not n(got.crc_ok).all()


@pytest.mark.parametrize("nflip", [0, 20])
def test_decode_slots_fused_fields(nflip):
    """Every field of decode_slots_fused equals the JAX result, with
    per-slot scrambling codes and kinds incl. -1."""
    slots, kinds = _mixed_slots(n=15, seed=7 + nflip, corrupt=nflip)
    kinds[4] = -1
    inits = np.full(len(slots), INIT, np.uint32)
    inits[::5] = 3
    got = fused.decode_slots_fused(t(slots), t(inits), t(kinds))
    want = j_fused.decode_slots_fused(jnp.asarray(slots), jnp.asarray(inits),
                                      jnp.asarray(kinds))
    assert np.array_equal(n(got["crc_ok"]), np.asarray(want["crc_ok"]))
    for key in ("sb1", "sb2", "schf", "ndb1", "ndb2", "bbk"):
        for a, b in zip(got[key], want[key]):
            assert np.array_equal(n(a), np.asarray(b)), key


def test_decode_slots_fused_batched_shape():
    slots, kinds = _mixed_slots(n=12, seed=1)
    got = fused.decode_slots_fused(t(slots.reshape(3, 4, 510)),
                                   t(np.full((3, 4), INIT, np.uint32)),
                                   t(kinds.reshape(3, 4)))
    assert got["schf"].type1.shape == (3, 4, 268)
    assert got["crc_ok"].shape == (3, 4) and bool(got["crc_ok"].all())
