"""Constant tables of the PyTorch port equal tetra_tpu's originals.

The port copies every numpy table builder it needs (tetra_tpu's modules
import jax); a copy that drifts from the original is caught here, one
test per table.
"""
import pathlib
import sys

import numpy as np
import pytest

import tests._torch_util  # noqa: F401  (caps torch threads)

from tetra_tpu import constants as C
from tetra_tpu.ops import crc as j_crc, rcpc as j_rcpc, \
    interleave as j_il, scramble as j_scr, viterbi as j_vit, \
    rm3014 as j_rm
from tetra_tpu.lmac import fused as j_fused, pipeline as j_pipe
from tetra_tpu.phy import pfb as j_pfb, dqpsk as j_dqpsk, \
    channelizer as j_ch
from tetra_tpu.io import stream as j_stream

from tetra_tpu_torch.ops import crc, rcpc, interleave, scramble, viterbi, \
    rm3014
from tetra_tpu_torch.ops.viterbi_assembled import pmat_to_index
from tetra_tpu_torch.lmac import fused, pipeline
from tetra_tpu_torch.phy import pfb, dqpsk, channelizer
from tetra_tpu_torch.io import stream
from tetra_tpu_torch import prod_fixture
from tetra_tpu_torch.rx_multi import pfb_demod_bits_len

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))


@pytest.mark.parametrize("length", [76, 140, 284, 60, 1])
def test_crc16_matrix(length):
    M, Cc = crc.crc16_matrix(length)
    Mj, Cj = j_crc.crc16_matrix(length)
    assert np.array_equal(M, Mj) and np.array_equal(Cc, Cj)


def test_puncture_indices():
    for scheme, n in (("2_3", 120), ("2_3", 216), ("2_3", 432),
                      ("2_3", 168), ("292_432", 432), ("148_432", 432)):
        assert np.array_equal(rcpc.puncture_indices(scheme, n),
                              j_rcpc.puncture_indices(scheme, n))


def test_interleave_indices():
    for K, a in ((120, 11), (216, 101), (432, 103), (168, 13)):
        for x, y in zip(interleave.interleave_indices(K, a),
                        j_il.interleave_indices(K, a)):
            assert np.array_equal(x, y)


def test_keystream_np():
    assert np.array_equal(scramble.keystream_matrix(432),
                          j_scr.keystream_matrix(432))
    for init in (C.SCRAMB_INIT, j_scr.scramb_get_init(262, 42, 1),
                 0xFFFFFFFF, 0x80000003):
        assert np.array_equal(scramble.keystream_np(init, 432),
                              j_scr.keystream_np(init, 432))


def test_rm3014_tables():
    assert np.array_equal(rm3014.generator_matrix(), j_rm.generator_matrix())
    assert np.array_equal(rm3014._parity_check(), j_rm._parity_check())
    assert np.array_equal(rm3014._syndrome_table(), j_rm._syndrome_table())


def test_trellis_tables():
    g = tuple(map(tuple, C.CONV_GENERATORS_CCH))
    assert np.array_equal(viterbi.trellis_signs(g), j_vit.trellis_signs(g))
    for name in ("_P0", "_P1", "_BIT"):
        assert np.array_equal(getattr(viterbi, name), getattr(j_vit, name))


def test_fused_maps():
    for x, y in zip(fused._maps(), j_fused._maps()):
        assert np.array_equal(x, y)


def test_fused_maps_planes():
    assert np.array_equal(fused._maps_planes(), j_fused._maps_planes())


def test_fec_matrix():
    for kind in ("SB1", "SB2", "NDB", "SCH_F", "SCH_HU"):
        assert np.array_equal(pipeline._fec_matrix(kind),
                              j_pipe._fec_matrix(kind))


def test_assembly_maps_are_one_hot():
    """Every assembly map row holds at most one nonzero, so K1's index
    gather equals the TPU kernel's one-hot matmul."""
    P2 = j_fused._maps_planes()
    pmats = [P2[k].T for k in range(3)]
    pmats.append(j_pipe._fec_matrix("SB1").T)
    for pm in pmats:
        assert ((pm != 0).sum(axis=1) <= 1).all()
        idx = pmat_to_index(pm).astype(np.int64)
        x = np.random.default_rng(0).integers(-1, 2, pm.shape[1])
        gathered = np.where(idx >= 0, x[np.maximum(idx, 0)], 0)
        assert np.array_equal(gathered, (pm != 0).astype(np.int64) @ x)
    with pytest.raises(ValueError):
        pmat_to_index(np.ones((2, 3)))


@pytest.mark.parametrize("n_chan", [8, 1024])
def test_pfb_prototype(n_chan):
    assert np.array_equal(pfb.pfb_prototype(n_chan),
                          j_pfb.pfb_prototype(n_chan))


def test_dft_matrices():
    for n_chan in (8, 16):
        for x, y in zip(pfb._dft_matrices(n_chan),
                        j_pfb._dft_matrices(n_chan)):
            assert np.array_equal(x, y)


def test_rrc_taps():
    for k in range(4):
        assert np.array_equal(dqpsk.rrc_taps(2, frac_shift=k / 4),
                              j_dqpsk.rrc_taps(2, frac_shift=k / 4))


def test_band_matrix():
    taps = tuple(j_dqpsk.rrc_taps(2).tolist())
    assert np.array_equal(dqpsk._band_matrix(22, 128, taps),
                          j_dqpsk._band_matrix(22, 128, taps))


def test_rational_ratio():
    for fs in (50_000.0, 2e5, 25.6e6, 48_000.0, 1e6 / 3):
        assert channelizer._rational_ratio(fs, 36_000.0) == \
            j_ch._rational_ratio(fs, 36_000.0)


def test_resample_block_plan():
    assert channelizer._N_PHASES == j_ch._N_PHASES
    assert channelizer.DEMOD_RATE == j_ch.DEMOD_RATE
    for n_in, skew in ((5000, -15.875), (1 << 20, -15.999), (300, 0.0)):
        a = channelizer._resample_block_plan(n_in, 50_000.0, 36_000.0,
                                             skew=skew)
        b = j_ch._resample_block_plan(n_in, 50_000.0, 36_000.0, skew=skew)
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]


def test_lloyd_max():
    assert np.array_equal(stream.LLOYD_MAX_16, j_stream.LLOYD_MAX_16)


def test_keystore_string():
    import bench_mc_e2e
    assert prod_fixture.KEYSTORE == bench_mc_e2e.KEYSTORE
    assert prod_fixture.HEAD_NOISE == bench_mc_e2e.HEAD_NOISE


@pytest.mark.parametrize("n_chan", [8, 1024])
def test_pfb_bits_len_closed_form(n_chan):
    """The closed form equals tetra_tpu's jax.eval_shape probe."""
    from tetra_tpu.rx_multi import _pfb_demod_bits_len
    fs = 25_000.0 * n_chan
    base = n_chan * 16
    lens = [base, base + 1, base + n_chan // 2 - 1, base + 7 * n_chan,
            50 * n_chan + 3, 125 * n_chan, 333 * n_chan + 17]
    for L in lens:
        assert pfb_demod_bits_len(L, n_chan, fs, 2) == \
            _pfb_demod_bits_len(L, n_chan, fs, 2), L


def test_fixture_rebuilds_mixed_batch():
    """The committed rows rebuild bench_mc_e2e.mixed_batch exactly."""
    import bench_mc_e2e
    want, n_enc = bench_mc_e2e.mixed_batch(16, 16, enc_frac=0.1)
    got, m_enc = prod_fixture.mixed_bits(16, 0.1)
    assert n_enc == m_enc and np.array_equal(got, want)
    fx = prod_fixture.load()
    assert int(fx["ref_n_encrypted"][0]) == round(1024 * 0.1)


def test_fixture_bits_path_stats():
    """The stored per-carrier JAX bits-path stats: their totals are the
    recorded bits-path counts, and the port's bits entry reproduces the
    rows of the first 12 carriers."""
    import torch
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    fx = prod_fixture.load()
    st = fx["jax_bits_stats"]
    assert st.shape == (1024, 3)
    assert st[:, 1].sum() == fx["ref_crc_ok"][1] and st[:, 2].sum() == 0
    bits, _ = prod_fixture.mixed_bits(1024, 0.1, fx)
    sub = bits[:12]
    with prod_fixture.keystore_file() as ks:
        rx = MultiCarrierReceiver([], fs=25e3 * 12, pfb_channels=np.arange(12),
                                  keystore_path=ks, control_plane="native",
                                  device=torch.device("cpu"))
        cuts = np.linspace(0, sub.shape[1], 5).astype(int)
        for k in range(4):
            rx.process_bits(sub[:, cuts[k]:cuts[k + 1]], final=k == 3)
    got = [(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong)
           for c in rx.carriers]
    assert np.array_equal(np.asarray(got), st[:12])


def test_fixture_chain_numpy_copies():
    """safe_rolls, modulate, synthesize_wideband_fft and quantize_iq4c
    equal tetra_tpu's byte for byte at 16 carriers."""
    import bench_mc_e2e
    fx = prod_fixture.load()
    L = len(fx["plain"])
    assert np.array_equal(prod_fixture.safe_rolls(16, L, int(fx["n_tail"])),
                          bench_mc_e2e.safe_rolls(16, L, int(fx["n_tail"])))
    bits, _ = prod_fixture.mixed_bits(16, 0.1, fx)
    bits = bits[:, :4000]
    base = dqpsk.modulate(bits, sps=2)
    assert np.array_equal(base, j_dqpsk.modulate(bits, sps=2))
    wide = channelizer.synthesize_wideband_fft(base, np.arange(16), 16)
    assert np.array_equal(
        wide, j_ch.synthesize_wideband_fft(base, np.arange(16), 16))
    assert np.array_equal(stream.quantize_iq4c(wide.real, wide.imag),
                          j_stream.quantize_iq4c(wide.real, wide.imag))


# ---- the port's copies of tetra_tpu's jax-free host modules -------------

_COPIES = ["constants", "tdma", "umac/native_exec", "crypto/crypto",
           "crypto/tea", "crypto/taa1", "crypto/hurdle", "crypto/native",
           "io/gsmtap", "io/tun", "umac/mac_pdu", "llc/llc_pdu", "llc/llc",
           "mle/mle", "umac/upper_mac", "io/sdr", "io/udp", "io/audio",
           "testpdu"]


# Names whose definitions a copy changed on purpose, in either module,
# each held by a test of its own: the port's u8 conversion is one float32
# pass under a span (test_torch_receiver.py::
# test_u8_conversion_is_bit_exact).
_DEPARTURES = {"io/sdr": {"trace", "_to_complex"}}


def _code(path: pathlib.Path, drop=frozenset()) -> str:
    """Module source after its docstring, with the package name
    normalised; without the module- or class-level imports, assignments
    and functions that define a name in `drop`, each cut with the blank
    lines after it when a blank line comes before it."""
    import ast
    src = path.read_text()
    tree = ast.parse(src)
    lines = src.splitlines()
    start = tree.body[1].lineno if ast.get_docstring(tree) else 1
    nodes = list(tree.body) + [n for c in tree.body
                               if isinstance(c, ast.ClassDef)
                               for n in c.body]
    cut = set()
    for node in nodes:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.FunctionDef):
            names = {node.name}
        else:
            continue
        if not names & drop:
            continue
        first = min([node.lineno] +
                    [d.lineno for d in getattr(node, "decorator_list", [])])
        last = node.end_lineno
        if first > 1 and not lines[first - 2].strip():
            while last < len(lines) and not lines[last].strip():
                last += 1
        cut.update(range(first, last + 1))
    code = "\n".join(ln for k, ln in enumerate(lines, 1)
                     if k >= start and k not in cut)
    return code.replace("tetra_tpu_torch", "tetra_tpu")


@pytest.mark.parametrize("mod", _COPIES)
def test_copied_module_code(mod):
    """Each copy's code equals the original's (docstring aside), but for
    the definitions it departs in on purpose (_DEPARTURES)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    drop = frozenset(_DEPARTURES.get(mod, ()))
    assert _code(root / "tetra_tpu_torch" / f"{mod}.py", drop) == \
        _code(root / "tetra_tpu" / f"{mod}.py", drop)


def _const_names():
    import types
    from tetra_tpu_torch import constants as PC
    return [k for k in vars(PC) if not k.startswith("_") and k.isupper()
            and not isinstance(vars(PC)[k], types.ModuleType)]


@pytest.mark.parametrize("name", _const_names())
def test_constant(name):
    from tetra_tpu_torch import constants as PC
    a, b = getattr(PC, name), getattr(C, name)
    if isinstance(a, (dict, tuple)):
        assert repr(a) == repr(b)
    else:
        assert type(a) is type(b)
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_carrier_hz():
    from tetra_tpu_torch import constants as PC
    for band, off, ch in ((4, 0, 1), (3, 2, 3999), (8, 1, 400)):
        assert PC.dl_carrier_hz(band, ch, off) == C.dl_carrier_hz(band, ch, off)
        for rev in (0, 1):
            assert PC.ul_carrier_hz(band, ch, off, 10, rev) == \
                C.ul_carrier_hz(band, ch, off, 10, rev)


def test_tdma_time():
    from tetra_tpu import tdma as j_tdma
    from tetra_tpu_torch import tdma
    for n in (1, 3, 255, 4 * 255 + 7, 100_000):
        a = tdma.TdmaTime(hn=2, mn=60, fn=18, tn=4, sn=250).add_sym(n)
        b = j_tdma.TdmaTime(hn=2, mn=60, fn=18, tn=4, sn=250).add_sym(n)
        assert (a.dump(), a.time2fn()) == (b.dump(), b.time2fn())
        a, b = a.copy().add_tn(n), b.copy().add_tn(n)
        assert (a.hn, a.mn, a.fn, a.tn) == (b.hn, b.mn, b.fn, b.tn)


def test_native_ev_kinds():
    from tetra_tpu.umac import native_exec as j_ne
    from tetra_tpu_torch.umac import native_exec as ne
    assert ne.EV.NAMES == j_ne.EV.NAMES
    for k, name in ne.EV.NAMES.items():
        assert getattr(ne.EV, name) == getattr(j_ne.EV, name) == k


@pytest.mark.parametrize("ksg", [1, 2, 3])
def test_tea_keystream(ksg):
    from tetra_tpu.crypto import tea as j_tea
    from tetra_tpu_torch.crypto import native, tea
    rng = np.random.default_rng(ksg)
    for _ in range(3):
        iv = int(rng.integers(0, 1 << 29))
        key = bytes(rng.integers(0, 256, 10).astype(np.uint8))
        fn = {1: "tea1", 2: "tea2", 3: "tea3"}[ksg]
        want = getattr(j_tea, fn)(iv, key, 35)
        assert getattr(tea, fn)(iv, key, 35) == want
        got = native.tea_keystream_batch(
            ksg, np.asarray([iv], np.uint32),
            np.frombuffer(key, np.uint8).reshape(1, 10), 35)[0]
        assert bytes(got) == want


def test_taa1_and_keystore(tmp_path):
    from tetra_tpu.crypto import crypto as j_crypto, taa1 as j_taa1
    from tetra_tpu.tdma import TdmaTime
    from tetra_tpu_torch.crypto import crypto, taa1
    key = bytes(range(0xA0, 0xAA))
    assert taa1.tb5(0x123, 0x2345, 0x15, key) == \
        j_taa1.tb5(0x123, 0x2345, 0x15, key)
    ks = tmp_path / "keys.txt"
    ks.write_text(prod_fixture.KEYSTORE)
    a, b = crypto.load_keystore(str(ks)), j_crypto.load_keystore(str(ks))
    assert [vars(k) | {"network_info": vars(k.network_info)} for k in a.keys] \
        == [vars(k) | {"network_info": vars(k.network_info)} for k in b.keys]
    assert [vars(n) for n in a.nets] == [vars(n) for n in b.nets]
    states = []
    for mod, db in ((crypto, a), (j_crypto, b)):
        tcs = mod.CryptoState(db=db, cck_id=7, hn=3, la=1000, cc=1)
        tcs.update_current_network(262, 42)
        t = TdmaTime(tn=2, fn=5, mn=17)
        states.append(mod.generate_keystream(tcs, tcs.cck, t, 274))
    assert states[0] is not None and np.array_equal(*states)


def test_crc_and_bit_helpers():
    from tetra_tpu.utils import bits as j_bits
    from tetra_tpu_torch.utils import bits
    rng = np.random.default_rng(3)
    for n in (0, 1, 31, 60, 76, 284, 300):
        x = rng.integers(0, 2, n).astype(np.uint8)
        assert crc.crc16_bits_np(x) == j_crc.crc16_bits_np(x)
        assert crc.fcs32_np(x) == j_crc.fcs32_np(x)
        assert bits.pack_bits(x) == j_bits.pack_bits(x)
        assert bits.bits_to_uint(x[:40]) == j_bits.bits_to_uint(x[:40])


def test_gsmtap_packet():
    from tetra_tpu.io import gsmtap as j_gt
    from tetra_tpu.tdma import TdmaTime as JT
    from tetra_tpu_torch.io import gsmtap
    from tetra_tpu_torch.tdma import TdmaTime
    x = np.random.default_rng(4).integers(0, 2, 124).astype(np.uint8)
    for lchan in range(13):
        args = (lchan, 2, 0, 0, 0, x)
        assert gsmtap.make_gsmtap_packet(TdmaTime(hn=1, mn=5, fn=7, tn=3),
                                         *args) == \
            j_gt.make_gsmtap_packet(JT(hn=1, mn=5, fn=7, tn=3), *args)
