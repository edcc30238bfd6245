"""The voice slice's operators of the PyTorch port vs tetra_tpu on the
CPU: K6's plain version (ops.viterbi_decode.decode_k6) against the TPU
kernel decode_pallas in interpret mode at odd n_sym and against the XLA
scan viterbi.decode, the decode_auto / decode_cch / decode_tch entries,
hard_to_soft, depuncture_soft at full and short lengths, and the TCH/S
chain (tch_s_decode, type2_to_codec) on encoded frames with bit flips
and on 216-bit NDB halves. All decisions must be bit-identical: on the
+-127/0 alphabet every float32 add is exact."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests._torch_util import n, t

from tetra_tpu import constants as C
from tetra_tpu.ops import acelp as j_acelp, rcpc as j_rcpc, \
    viterbi as j_vit
from tetra_tpu.ops.viterbi_pallas import decode_pallas

from tetra_tpu_torch.ops import acelp, rcpc, viterbi
from tetra_tpu_torch.ops.viterbi_decode import decode_k6

CODES = {"cch": C.CONV_GENERATORS_CCH, "tch": C.CONV_GENERATORS_TCH}


def _soft(kind: str, rows: int, n_sym: int, code: str, seed: int):
    """Soft mother rows [rows, n_sym*N] float32: 'garbage' (+-127 or 0
    at random), 'clean' (codewords of random bits from the JAX encoder,
    tails zero, with a few erasures) or 'erased' (all 0: pure ties)."""
    gens = CODES[code]
    N = len(gens)
    rng = np.random.default_rng(seed)
    if kind == "garbage":
        return (rng.integers(-1, 2, (rows, n_sym * N)) * 127) \
            .astype(np.float32)
    if kind == "erased":
        return np.zeros((rows, n_sym * N), np.float32)
    u = rng.integers(0, 2, (rows, n_sym)).astype(np.int8)
    u[:, -4:] = 0
    mother = np.asarray(j_rcpc.conv_encode(jnp.asarray(u), gens))
    soft = (1.0 - 2.0 * mother) * 127.0
    soft[rng.random(soft.shape) < 0.1] = 0
    return soft.astype(np.float32)


@pytest.mark.parametrize("kind", ["garbage", "clean", "erased"])
@pytest.mark.parametrize("n_sym,code", [(77, "cch"), (113, "tch"),
                                        (71, "tch")])
def test_k6_plain_vs_pallas_interpret(n_sym, code, kind):
    """Odd n_sym runs the TPU kernel's own body (_make_kernel)."""
    soft = _soft(kind, 20, n_sym, code, seed=n_sym)
    gens = tuple(map(tuple, CODES[code]))
    want = decode_pallas(jnp.asarray(soft), n_sym, gens, tile_b=8,
                         interpret=True)
    got = decode_k6(t(soft), n_sym, gens)
    assert got.dtype == torch.int8
    assert np.array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["garbage", "clean", "erased"])
@pytest.mark.parametrize("n_sym", [112, 72])
def test_k6_plain_vs_scan(n_sym, kind):
    """The voice path's shapes (TCH code) against the XLA scan."""
    soft = _soft(kind, 48, n_sym, "tch", seed=n_sym + 1)
    want = j_vit.decode(jnp.asarray(soft), n_sym, C.CONV_GENERATORS_TCH)
    got = decode_k6(t(soft), n_sym, C.CONV_GENERATORS_TCH)
    assert np.array_equal(n(got), np.asarray(want))
    if kind == "clean":
        assert (n(got)[:, -4:] == 0).all()
    if kind == "erased":
        assert not n(got).any()


@pytest.mark.parametrize("entry", ["decode_auto", "decode_cch", "decode_tch"])
def test_decode_entries(entry):
    """Batch dims [2, 3, ...] and an int8 input are handled as JAX does
    (cast to float32, leading dims kept)."""
    rng = np.random.default_rng(5)
    code = "tch" if entry == "decode_tch" else "cch"
    N = len(CODES[code])
    soft = rng.integers(-127, 128, (2, 3, 40 * N + 5)).astype(np.int8)
    args = (40,) if entry != "decode_auto" else (40, CODES[code])
    want = getattr(j_vit, entry)(jnp.asarray(soft), *args)
    got = getattr(viterbi, entry)(t(soft), *args)
    assert got.shape == (2, 3, 40)
    assert np.array_equal(n(got), np.asarray(want))


def test_hard_to_soft():
    bits = np.asarray([[0, 1, 255, 1, 0, 255]], np.uint8)
    assert np.array_equal(n(viterbi.hard_to_soft(t(bits))),
                          np.asarray(j_vit.hard_to_soft(jnp.asarray(bits))))


def test_k6_wrapper_never_falls_back():
    """The CUDA wrapper's argument checks never fall back to the plain
    version: a CPU tensor runs plain, anything else is refused before a
    launch (a meta tensor stands in for a card tensor here)."""
    soft = torch.empty((4, 3 * 10), device="meta")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        decode_k6(soft, 10, C.CONV_GENERATORS_TCH)


@pytest.mark.parametrize("scheme,mother,lengths", [
    ("112_168", 336, [168, 114, 1]),
    ("72_162", 216, [162, 60, 0]),
])
def test_depuncture_soft(scheme, mother, lengths):
    rng = np.random.default_rng(len(scheme))
    for L in lengths:
        x = ((1 - 2 * rng.integers(0, 2, (3, L))) * 127).astype(np.float32)
        want = j_rcpc.depuncture_soft(scheme, jnp.asarray(x), mother)
        got = rcpc.depuncture_soft(scheme, t(x), mother)
        assert got.shape == (3, mother) and got.dtype == torch.float32
        assert np.array_equal(n(got), np.asarray(want)), L


def _frames(rows: int, seed: int, flip: float):
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, 2, (rows, 102))
    c1 = rng.integers(0, 2, (rows, 108))
    c2 = rng.integers(0, 2, (rows, 64))
    t3 = np.asarray(j_acelp.tch_s_encode(jnp.asarray(c0), jnp.asarray(c1),
                                         jnp.asarray(c2))).astype(np.int8)
    return t3 ^ (rng.random(t3.shape) < flip).astype(np.int8)


@pytest.mark.parametrize("flip", [0.0, 0.03, 0.15])
@pytest.mark.parametrize("width", [432, 216])
def test_tch_s_decode(width, flip):
    """Full frames and NDB halves: every output identical, and the codec
    reordering of the decoded line too."""
    t3 = _frames(24, int(flip * 100) + width, flip)[:, :width]
    want = j_acelp.tch_s_decode(jnp.asarray(t3))
    got = acelp.tch_s_decode(t(t3))
    for w, g in zip(want, got):
        assert np.array_equal(n(g), np.asarray(w))
    if width == 216:
        assert not n(got[2]).any() and n(got[4]).all()
    elif flip == 0.0:
        assert n(got[3]).all() and n(got[4]).all()
    line = np.concatenate([np.asarray(w) for w in want[:3]], axis=-1)
    assert np.array_equal(n(acelp.type2_to_codec(t(line))),
                          np.asarray(j_acelp.type2_to_codec(
                              jnp.asarray(line))))


def test_acelp_maps():
    assert np.array_equal(acelp._maps(), j_acelp._maps())
