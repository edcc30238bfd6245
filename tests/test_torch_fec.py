"""FEC of the PyTorch port vs tetra_tpu on the CPU: scrambling, CRC16,
the plain version of kernel K1 (assembly gather + segmented Viterbi +
CRC), the SB1 decode and the fused mixed-kind decode — all bit-exact."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests._torch_util import t, n
from tests.test_fused import _mixed_slots, INIT

from tetra_tpu.ops import crc as j_crc, scramble as j_scr, viterbi as j_vit
from tetra_tpu.lmac import fused as j_fused, pipeline as j_pipe
from tetra_tpu.ops.viterbi_pallas import (decode_assembled_pallas,
                                          decode_pallas,
                                          decode_segmented_pallas)

from tetra_tpu_torch.constants import CONV_GENERATORS_CCH
from tetra_tpu_torch.ops import crc, scramble, viterbi
from tetra_tpu_torch.ops.viterbi_assembled import decode_assembled
from tetra_tpu_torch.ops.viterbi_segmented import (MAX_SYM, boundaries_ok,
                                                   decode_segmented_k4)
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


def _soft292(kind: str, rows: int, seed: int) -> np.ndarray:
    """TCH/4.8 mother rows [rows, 292 * 4] float32 from a numpy seed:
    'garbage' (+-127 or 0 at random), 'sparse' (90% erasures) or
    'erased' (all 0: pure ties)."""
    rng = np.random.default_rng(seed)
    soft = (rng.integers(-1, 2, (rows, 292 * 4)) * 127).astype(np.float32)
    if kind == "sparse":
        soft[rng.random(soft.shape) < 0.9] = 0
    elif kind == "erased":
        soft[:] = 0
    return soft


@pytest.mark.parametrize("kind", ["garbage", "sparse", "erased"])
def test_decode_cch_292_vs_jax(kind):
    """TCH/4.8's 292 steps (control-channel code, N 4) through the
    port's viterbi.decode_cch (decode_k6, plain on the CPU) equal
    tetra_tpu.ops.viterbi.decode_cch, and on a few rows the TPU kernel
    decode_pallas in interpret mode."""
    soft = _soft292(kind, 24, seed=292)
    got = n(viterbi.decode_cch(t(soft), 292))
    assert got.shape == (24, 292) and got.dtype == np.int8
    assert np.array_equal(got, np.asarray(j_vit.decode_cch(
        jnp.asarray(soft), 292)))
    want = decode_pallas(jnp.asarray(soft[:8]), 292,
                         tuple(map(tuple, CONV_GENERATORS_CCH)), tile_b=8,
                         interpret=True)
    assert np.array_equal(got[:8], np.asarray(want))
    if kind == "erased":
        assert not got.any()


@pytest.mark.parametrize("boundaries", [(80, 144, 224), (2, 146), ()])
def test_k4_plain_292_vs_pallas_interpret(boundaries):
    """K4's plain version at 292 steps with restarts equals the TPU
    kernel decode_segmented_pallas in interpret mode."""
    soft = _soft292("garbage", 16, seed=len(boundaries))
    soft[:4] = 0
    rm = np.random.default_rng(7).integers(0, 2, (16, len(boundaries)))
    want = decode_segmented_pallas(jnp.asarray(soft), jnp.asarray(rm), 292,
                                   boundaries, tile_b=16, interpret=True)
    got = decode_segmented_k4(t(soft), t(rm, torch.int8), 292, boundaries)
    assert np.array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("n_sym,bnd,good", [
    (288, (80, 144, 224), True), (292, (2, 146), True), (77, (), True),
    (288, (144, 80), False), (288, (80, 80), False), (288, (288,), False),
    (288, (8, 16, 24, 32), False), (288, (-1,), False)])
def test_viterbi_boundaries_ok(n_sym, bnd, good):
    """The restart boundaries K1 and K4 take: at most three, strictly
    ascending, inside the trellis (the kernels' segment loops)."""
    assert boundaries_ok(bnd, n_sym) == good
    assert MAX_SYM == 292


@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_viterbi_wrappers_never_fall_back(kernel):
    """K1's and K4's wrappers run the plain version only for CPU
    tensors; anything else is refused before a launch (a meta tensor
    stands in for a card tensor here)."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    rm = meta((4, 3), torch.int8)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        if kernel == "k4":
            decode_segmented_k4(meta((4, 1152), torch.float32), rm, 288,
                                fused.BOUNDARIES)
        else:
            decode_assembled(meta((4, 512), torch.int8),
                             meta((3, 1152), torch.int16),
                             meta((4,), torch.int32), rm,
                             meta((5, 288), torch.int32),
                             meta((5,), torch.int32), 288, fused.BOUNDARIES,
                             fused.CRC_SEGS)
