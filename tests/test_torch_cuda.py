"""Hand-written CUDA kernels of the port vs their plain PyTorch versions.

These need a CUDA card and nvcc (the kernels build on first use); on a
machine without a card they skip. On the card (which has no jax, so
tests/conftest.py is not loaded):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from chip_smoke import (K6_RAGGED, K6_SHAPES, k1_edge_rows, k4_edge_rows,
                        k6_edge_rows, k6_rows, sync_case, sync_compare)
from tetra_tpu_torch import constants as C, steady_fixture
from tetra_tpu_torch.lmac import fused
from tetra_tpu_torch.lmac.pipeline import _block_decoder
from tetra_tpu_torch.ops import acelp
from tetra_tpu_torch.ops.viterbi import decode, decode_segmented
from tetra_tpu_torch.ops.viterbi_decode import decode_k6
from tetra_tpu_torch.ops.viterbi_assembled import decode_assembled_plain
from tetra_tpu_torch.ops.viterbi_segmented import decode_segmented_k4
from tetra_tpu_torch.phy import demod_fused, dqpsk, pfb

pytestmark = pytest.mark.cuda


def cuda_device() -> torch.device:
    """The card, or skip. Decided inside each test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", ["n288", "n80"])
def test_k1_matches_plain(shape):
    dev = cuda_device()
    g = torch.Generator().manual_seed(3)
    if shape == "n288":
        code = fused.fused_tables(dev).code
        tab = torch.randint(0, 3, (3000,), generator=g).to(torch.int32)
        rm = fused.fused_tables(torch.device("cpu")).rmask[tab.long()]
        K = 512
    else:
        code = _block_decoder("SB1", dev).code
        tab = torch.zeros(3000, dtype=torch.int32)
        rm = torch.zeros((3000, 0), dtype=torch.int8)
        K = 120
    x = torch.randint(-1, 2, (3000, K), generator=g).to(torch.int8)
    x, tab, rm = x.to(dev), tab.to(dev), rm.to(dev)
    bits, ok = code(x, tab, rm)
    bp, okp = decode_assembled_plain(x, code.pidx, tab, rm, code.n_sym,
                                     code.boundaries, code.crc_segs)
    assert torch.equal(bits, bp) and torch.equal(ok, okp)


def k1_edge_inputs(name: str, B: int, dev):
    """K1 inputs of one shape at B rows: random signs with tab cycling
    through every map, then chip_smoke.k1_edge_rows (all-erasure rows,
    rows tied before the first boundary, every restart subset)."""
    code = {"n288": lambda: fused.fused_tables(dev).code,
            "n80": lambda: _block_decoder("SB1", dev).code,
            "n144": lambda: _block_decoder("NDB", dev).code}[name]()
    K = {"n288": 512, "n80": 120, "n144": 216}[name]
    g = torch.Generator().manual_seed(B)
    x = torch.randint(-1, 2, (B, K), generator=g).to(torch.int8).to(dev)
    tab = (torch.arange(B, device=dev) % code.pidx.shape[0]).to(torch.int32)
    return (code, *k1_edge_rows(code, x, tab))


@pytest.mark.parametrize("B", [1, 3, 17, 3001])
@pytest.mark.parametrize("shape", ["n288", "n80", "n144"])
def test_k1_edge_cases(shape, B):
    """K1 bit-identical to its plain version (bits and CRC flags) at row
    counts that fill no warp or block, on all-erasure rows, on rows
    tied at a restart boundary, with tab mixing every map and every
    subset of the restarts."""
    from tetra_tpu_torch.ops.viterbi_assembled import decode_assembled
    dev = cuda_device()
    code, x, tab, rm = k1_edge_inputs(shape, B, dev)
    n0 = decode_assembled.launches
    bits, ok = code(x, tab, rm)
    assert decode_assembled.launches == n0 + 1
    bp, okp = decode_assembled_plain(x, code.pidx, tab, rm, code.n_sym,
                                     code.boundaries, code.crc_segs)
    assert torch.equal(bits, bp) and torch.equal(ok, okp)
    assert not bits[::5].any()


def k4_edge_inputs(n_sym: int, bnd: tuple, B: int, dev):
    """K4 inputs at B rows: the soft path's alphabet (int8 x 127, 3/8
    erasures) with every fifth row from the third dyadic fractions, then
    chip_smoke.k4_edge_rows (all-erasure rows, rows tied before the
    first boundary, every restart subset)."""
    g = torch.Generator().manual_seed(B + n_sym)
    x = (torch.randint(-124, 125, (B, 4 * n_sym), generator=g) * 127
         ).to(torch.float32)
    x[torch.rand(x.shape, generator=g) < 0.375] = 0
    x[2::5] = torch.randint(-8, 9, x[2::5].shape, generator=g) * 0.25
    return k4_edge_rows(x.to(dev), n_sym, bnd)


@pytest.mark.parametrize("B", [1, 3, 17, 3001])
@pytest.mark.parametrize("shape", ["n288", "n80", "n77_two_restarts",
                                   "n292"])
def test_k4_edge_cases(shape, B):
    """K4 bit-identical to its plain version at row counts that fill no
    warp or block, on all-erasure rows, on rows tied at a restart
    boundary and with every subset of the restarts; n292 is TCH/4.8's
    trellis length."""
    dev = cuda_device()
    n_sym, bnd = {"n288": (288, fused.BOUNDARIES), "n80": (80, ()),
                  "n77_two_restarts": (77, (20, 52)),
                  "n292": (292, (80, 144, 224))}[shape]
    x, rm = k4_edge_inputs(n_sym, bnd, B, dev)
    n0 = decode_segmented_k4.launches
    bits = decode_segmented_k4(x, rm, n_sym, bnd)
    assert decode_segmented_k4.launches == n0 + 1
    assert torch.equal(bits, decode_segmented(x, rm, n_sym, bnd))
    assert not bits[::5].any()


def test_k4_reads_row_major_strides():
    """K4 reads a row-major input wider than n_sym * N (no transpose,
    row stride from the tensor) and every code width N = 1..4."""
    dev = cuda_device()
    g = torch.Generator().manual_seed(21)
    for gens in (C.CONV_GENERATORS_CCH, C.CONV_GENERATORS_TCH,
                 ((1, 4), (2, 3, 4)), ((1, 3, 4),)):
        n = len(gens)
        x = (torch.randint(-1, 2, (300, 80 * n + 7), generator=g) * 127
             ).float().to(dev)
        rm = torch.randint(0, 2, (300, 2), generator=g).to(torch.int8)
        rm = rm.to(dev)
        got = decode_segmented_k4(x, rm, 80, (16, 33), gens)
        assert torch.equal(got, decode_segmented(x, rm, 80, (16, 33), gens))


@pytest.mark.parametrize("shape", ["n288", "n80", "n77_two_restarts"])
def test_k4_matches_plain(shape):
    """K4 bit-identical to its plain version on integer soft values of
    the soft path's alphabet and on dyadic fractions, random restarts."""
    dev = cuda_device()
    g = torch.Generator().manual_seed(5)
    n_sym, bnd = {"n288": (288, fused.BOUNDARIES), "n80": (80, ()),
                  "n77_two_restarts": (77, (20, 52))}[shape]
    B = 3000
    x = (torch.randint(-124, 125, (B, 4 * n_sym), generator=g) * 127
         ).to(torch.float32)
    x[torch.rand(x.shape, generator=g) < 0.375] = 0
    x[:500] = torch.randint(-8, 9, (500, 4 * n_sym), generator=g) * 0.25
    rm = torch.randint(0, 2, (B, len(bnd)), generator=g).to(torch.int8)
    x, rm = x.to(dev), rm.to(dev)
    bits = decode_segmented_k4(x, rm, n_sym, bnd)
    assert torch.equal(bits, decode_segmented(x, rm, n_sym, bnd))


# K6's row count at each launch of the voice-1024 pass (chip_smoke.py's
# voice phase, k6_rows_per_launch): one chunk's full frames or its NDB
# halves
VOICE_ROWS = (286, 1018, 1220, 1221, 1369, 2245, 2392, 2536)
CODES = {"tch": C.CONV_GENERATORS_TCH, "cch": C.CONV_GENERATORS_CCH}


@pytest.mark.parametrize("B", K6_RAGGED + VOICE_ROWS)
@pytest.mark.parametrize("n_sym", list(K6_SHAPES))
def test_k6_matches_plain(n_sym, B):
    """K6 bit-identical to its plain version on the voice alphabet
    (+-127 or 0, half the rows erasure-heavy) with chip_smoke's edge
    rows: all-erasure rows (pure ties), rows zeroed before step
    n_sym // 2, rows of multiples of 0.25; at row counts that fill no
    block, warp or wave and at the voice pass's own; TCH/S's n112 and
    n72, odd n77, n113, n71 and TCH/4.8's n292."""
    dev = cuda_device()
    gens = CODES[K6_SHAPES[n_sym]]
    x = k6_edge_rows(k6_rows(B, n_sym, len(gens), B + n_sym, dev), n_sym,
                     len(gens))
    n0 = decode_k6.launches
    bits = decode_k6(x, n_sym, gens)
    assert decode_k6.launches == n0 + 1
    assert torch.equal(bits, decode(x, n_sym, gens))
    assert not bits[::5].any()


def test_k6_contiguous_f32_is_one_launch():
    """A contiguous float32 input, and a column slice of a wider one (read
    in place with its row stride), is K6's one launch and nothing else:
    no cast, copy or transpose."""
    from torch.profiler import ProfilerActivity, profile
    dev = cuda_device()
    gens = C.CONV_GENERATORS_TCH
    x = k6_rows(2000, 116, 3, 1, dev)
    for soft in (x[:, :336].contiguous(), x):
        want = decode(soft, 112, gens)
        decode_k6(soft, 112, gens)            # the code table's one copy
        torch.cuda.synchronize()
        n0 = decode_k6.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bits = decode_k6(soft, 112, gens)
            torch.cuda.synchronize()
        assert decode_k6.launches == n0 + 1
        ops = {e.key for e in prof.key_averages()}
        assert not ops & {"aten::copy_", "aten::_to_copy", "aten::clone",
                          "aten::contiguous", "aten::t", "aten::transpose"}
        kern = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kern) <= 1 and all("viterbi" in k for k in kern)
        assert torch.equal(bits, want)


def test_k6_reads_row_major_views():
    """K6 reads float32 column slices in place at any offset and row
    stride (16-byte aligned or not: N = 4 takes 16-byte loads only where
    the rows allow), for every code width N = 1..4."""
    dev = cuda_device()
    g = torch.Generator().manual_seed(22)
    for gens in (C.CONV_GENERATORS_CCH, C.CONV_GENERATORS_TCH,
                 ((1, 4), (2, 3, 4)), ((1, 3, 4),)):
        n = len(gens)
        x = (torch.randint(-1, 2, (301, 80 * n + 9), generator=g) * 127
             ).float().to(dev)
        for off in (0, 1, 4, 9):
            view = x[:, off:off + 80 * n]
            assert torch.equal(decode_k6(view, 80, gens),
                               decode(view, 80, gens))


def test_voice_decode_on_card_matches_cpu():
    """tch_s_decode through K6 equals the CPU plain scan, on full frames
    and on 216-bit NDB halves."""
    dev = cuda_device()
    t3 = torch.randint(0, 2, (500, 432),
                       generator=torch.Generator().manual_seed(9))
    for width in (432, 216):
        got = acelp.tch_s_decode(t3[:, :width].to(dev))
        want = acelp.tch_s_decode(t3[:, :width])
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n_chan,T", [
    (8, 40_000), (1024, 400_000), (12, 30_000), (16, 20_000),
    (2048, 16 * 2048 + 12 * 1024), (4096, 16 * 4096 + 16 * 2048),
    (64, 700)])
def test_k2_k3_match_plain(n_chan, T):
    """K2 and K3 within 1e-4 x max|plain| of their plain versions: C a
    power of two from 8 to 4096 (one, two and three FFT passes), C = 12
    (direct DFT), frame counts that are not a multiple of the block's
    (750 at C 1024, 13 at 2048, 17 at 4096) and T < J·C (one padded
    frame)."""
    dev = cuda_device()
    fe = pfb.PfbFrontEnd(n_chan, 25_000.0 * n_chan).to(dev)
    g = torch.Generator().manual_seed(n_chan)
    re = torch.randn(T, generator=g).to(dev)
    im = torch.randn(T, generator=g).to(dev)
    n0 = pfb.pfb_channelize_rows.launches
    yk = pfb.pfb_channelize_rows(re, im, fe.h, fe.twc, fe.tws, n_chan, fe.J)
    assert pfb.pfb_channelize_rows.launches == n0 + 1
    yp = pfb.pfb_channelize_rows_plain(
        torch.nn.functional.pad(re, (0, max(n_chan * fe.J - T, 0))),
        torch.nn.functional.pad(im, (0, max(n_chan * fe.J - T, 0))),
        fe.h, n_chan, fe.J)
    for a, b in zip(yk, yp):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    n_out = fe.n_out(yp[0].shape[0])
    if n_out == 0:
        return
    k3_layouts_match_plain(fe, *yp, n_out, g)


def k3_layouts_match_plain(fe, yr, yi, n_out, g):
    """K3 on rows (yr, yi) within 1e-4 x max|plain| of its plain versions
    in both layouts: time-major, channel-major over all channels, over a
    random subset (int64) and over a permutation of all (int32); one
    launch each."""
    C = yr.shape[1]
    args = (fe.rs_taps, fe.rs_off, fe.W, fe.bmin, fe.L, fe.M, n_out)
    plain = (fe.W, fe.bmin, fe.L, fe.M, n_out)
    perm = torch.randperm(C, generator=g)
    cases = [(False, None), (True, None),
             (True, perm[:max(C // 3, 1)].to(yr.device)),
             (True, perm.to(torch.int32).to(yr.device))]
    for cm, idx in cases:
        n0 = pfb.resample_rows.launches
        got = pfb.resample_rows(yr, yi, *args, channel_major=cm,
                                channel_idx=idx)
        assert pfb.resample_rows.launches == n0 + 1
        want = (pfb.resample_channels_plain(yr, yi, *plain, idx) if cm
                else pfb.resample_rows_plain(yr, yi, *plain))
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.is_contiguous()
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("C,n_in", [(3, 200), (1000, 700), (4096, 97),
                                    (12, 9), (8, 31)])
def test_k3_ragged_shapes(C, n_in):
    """K3 alone on random rows: channel counts that fill no tile (3,
    1000, 12), n_out 0 (no launch, empty outputs of the layout's shape),
    short inputs and a stage tail."""
    dev = cuda_device()
    fe = pfb.PfbFrontEnd(8, 2e5).to(dev)
    g = torch.Generator().manual_seed(C + n_in)
    yr = torch.randn(n_in, C, generator=g).to(dev)
    yi = torch.randn(n_in, C, generator=g).to(dev)
    n_out = fe.n_out(n_in)
    if n_out:
        k3_layouts_match_plain(fe, yr, yi, n_out, g)
        return
    n0 = pfb.resample_rows.launches
    for cm in (False, True):
        a, b = pfb.resample_rows(yr, yi, fe.rs_taps, fe.rs_off, fe.W,
                                 fe.bmin, fe.L, fe.M, 0, channel_major=cm)
        assert a.shape == b.shape == ((C, 0) if cm else (0, C))
    assert pfb.resample_rows.launches == n0


def test_k3_rejects_bad_arguments():
    dev = cuda_device()
    fe = pfb.PfbFrontEnd(16, 400_000.0).to(dev)
    x = torch.zeros(400, 16, device=dev)
    args = (fe.rs_taps, fe.rs_off, fe.W, fe.bmin, fe.L, fe.M, 200)
    idx = torch.arange(4, device=dev)
    with pytest.raises(ValueError):
        pfb.resample_rows(x, x[:300], *args)
    with pytest.raises(TypeError):
        pfb.resample_rows(x.double(), x.double(), *args)
    with pytest.raises(ValueError):
        pfb.resample_rows(x.T, x.T, *args)
    with pytest.raises(ValueError):
        pfb.resample_rows(x, x.cpu(), *args)
    with pytest.raises(ValueError):
        pfb.resample_rows(x, x, *args, channel_major=True,
                          channel_idx=torch.tensor([0, 16], device=dev))
    with pytest.raises(ValueError):
        pfb.resample_rows(x, x, *args, channel_major=True,
                          channel_idx=torch.tensor([-1, 3], device=dev))
    with pytest.raises(ValueError):
        pfb.resample_rows(x, x, *args, channel_major=True,
                          channel_idx=idx.cpu())
    with pytest.raises(TypeError):
        pfb.resample_rows(x, x, *args, channel_major=True,
                          channel_idx=idx.float())
    with pytest.raises(ValueError):
        pfb.resample_rows(x, x, *args, channel_idx=idx)


@pytest.mark.parametrize("subset", [False, True])
def test_front_end_runs_no_copy_between_k2_and_k3(subset):
    """One pfb_to_demod_rate_ri call on the card launches K2 and then K3
    (channel-major, reading the subset's columns in place) and no other
    kernel: no gather, no transpose (torch.profiler kernel names)."""
    from torch.profiler import ProfilerActivity, profile
    dev = cuda_device()
    n_chan, fs = 64, 64 * 25_000.0
    g = torch.Generator().manual_seed(7)
    re = torch.randn(60_000, generator=g).to(dev)
    im = torch.randn(60_000, generator=g).to(dev)
    idx = (torch.tensor([5, 0, 3, 63, 17], device=dev) if subset else None)
    want = pfb.pfb_to_demod_rate_ri(re, im, idx, n_chan, fs)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = pfb.pfb_to_demod_rate_ri(re, im, idx, n_chan, fs)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2, names
    assert "pfb_wola" in names[0] and "resample" in names[1], names
    assert got[0].shape == (5 if subset else n_chan, want[0].shape[1])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k2_rejects_bad_arguments():
    dev = cuda_device()
    fe = pfb.PfbFrontEnd(16, 400_000.0).to(dev)
    x = torch.zeros(4000, device=dev)
    with pytest.raises(TypeError):
        pfb.pfb_channelize_rows(x.double(), x.double(), fe.h, fe.twc,
                                fe.tws, 16, 16)
    with pytest.raises(ValueError):
        pfb.pfb_channelize_rows(x, x[:3000], fe.h, fe.twc, fe.tws, 16, 16)
    with pytest.raises(ValueError):
        pfb.pfb_channelize_rows(x, x.cpu(), fe.h, fe.twc, fe.tws, 16, 16)
    with pytest.raises(ValueError):
        pfb.pfb_channelize_rows(x, x, fe.h, fe.twc, fe.tws, 16, 8)
    with pytest.raises(ValueError):
        pfb.pfb_channelize_rows(x, x, fe.h[:-1], fe.twc, fe.tws, 16, 16)
    big = pfb.PfbFrontEnd(8192, 25_000.0 * 8192).to(dev)
    y = torch.zeros(16 * 8192, device=dev)
    with pytest.raises(ValueError):
        pfb.pfb_channelize_rows(y, y, big.h, big.twc, big.tws, 8192, 16)


def test_wrappers_reject_bad_arguments():
    dev = cuda_device()
    code = _block_decoder("SB1", dev).code
    x = torch.zeros((4, 120), dtype=torch.int16, device=dev)
    z4 = torch.zeros(4, dtype=torch.int32, device=dev)
    r0 = torch.zeros((4, 0), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        code(x, z4, r0)
    x8 = torch.zeros((4, 240), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        code(x8[:, ::2], z4, r0)
    with pytest.raises(TypeError):
        code(x8[:, :120].contiguous(), z4.long(), r0)
    with pytest.raises(ValueError):
        code(x8[:, :120].contiguous(), z4[:3], r0)
    soft = torch.zeros((4, 1152), dtype=torch.float32, device=dev)
    rm = torch.zeros((4, 3), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        decode_segmented_k4(soft.double(), rm, 288, fused.BOUNDARIES)
    with pytest.raises(ValueError):
        decode_segmented_k4(soft, rm, 290, fused.BOUNDARIES)
    wide = torch.zeros((4, 4 * 293), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        decode_segmented_k4(wide, rm, 293, fused.BOUNDARIES)
    with pytest.raises(ValueError):
        decode_segmented_k4(wide[:, :1152].clone(), rm, 288, (144, 80, 224))
    with pytest.raises(ValueError):
        decode_segmented_k4(wide[:, :1152], rm, 288, fused.BOUNDARIES)
    with pytest.raises(ValueError):
        decode_segmented_k4(soft, rm.t().contiguous().t(), 288,
                            fused.BOUNDARIES)
    with pytest.raises(TypeError):
        decode_segmented_k4(soft, rm.to(torch.int32), 288, fused.BOUNDARIES)
    with pytest.raises(ValueError):
        decode_k6(wide, 293)
    with pytest.raises(ValueError):
        decode_k6(soft, 289)
    with pytest.raises(ValueError):
        decode_k6(soft[:, :100], 112, C.CONV_GENERATORS_TCH)
    with pytest.raises(ValueError):
        decode_k6(soft[:, :300:2], 112, C.CONV_GENERATORS_TCH)


def test_k6_casts_like_the_tpu_kernel():
    """K6 takes any real dtype, strides and leading dims, as
    decode_pallas does: int8 [2, 3, W] and a strided f64 view decode as
    the plain version decodes them."""
    dev = cuda_device()
    g = torch.Generator().manual_seed(4)
    x = torch.randint(-127, 128, (2, 3, 2 * 336 + 5), generator=g)
    for soft in (x[..., :336 + 5].to(torch.int8), x[..., ::2].double()):
        got = decode_k6(soft.to(dev), 112, C.CONV_GENERATORS_TCH)
        assert got.shape == (2, 3, 112)
        assert torch.equal(got.cpu(),
                           decode(soft, 112, C.CONV_GENERATORS_TCH))


def k5_planes(shape: str):
    """K5 card-test inputs (numpy re, im [C, T] f32, noisy [C] bool)."""
    if shape == "ragged_7x602":
        bits = np.random.default_rng(14).integers(0, 2, (7, 602))
        iq = dqpsk.modulate(bits.astype(np.uint8), sps=2)
        return (iq.real.astype(np.float32), iq.imag.astype(np.float32),
                np.zeros(7, bool))
    if shape == "one_carrier":
        re, im = steady_fixture.capture(1, seed=3)
        return re[:, :9_001].copy(), im[:, :9_001].copy(), np.zeros(1, bool)
    if shape == "4096_carriers_short":
        re, im = steady_fixture.capture(4096, noisy=range(2048, 4096),
                                        seed=4)
        return (re[:, :2_500].copy(), im[:, :2_500].copy(),
                np.arange(4096) >= 2048)
    re, im = steady_fixture.capture(8, noisy=range(4, 8), seed=2)
    noisy = np.arange(8) >= 4
    T = {"steady_8": re.shape[1], "short_5000": 5_000, "odd_4097": 4_097,
         "under_one_tile_255": 255}[shape]
    return re[:, :T].copy(), im[:, :T].copy(), noisy


@pytest.mark.parametrize("shape", ["steady_8", "ragged_7x602", "short_5000",
                                   "odd_4097", "under_one_tile_255",
                                   "one_carrier", "4096_carriers_short"])
def test_k5_matches_plain(shape):
    """K5 vs its plain version: identical bits on clean carriers, <= 1e-3
    differing on carriers with AWGN at 8 dB, the same timing phase on
    every carrier and the metric sums within 1e-5 relative; T not a
    multiple of the 2048-sample tile, odd, under one tile; C 1, 7, 8 and
    4096. The slot-framed entry's slots are a view of its bits."""
    dev = cuda_device()
    re, im, noisy = k5_planes(shape)
    re, im = torch.as_tensor(re, device=dev), torch.as_tensor(im, device=dev)
    n0 = demod_fused.demod_fused.launches
    bits, best, met = demod_fused.demod_fused(re, im)
    assert demod_fused.demod_fused.launches == n0 + 1
    want, best_p, met_p = demod_fused.demod_fused_plain(re, im)
    got, want = bits.cpu().numpy(), want.cpu().numpy()
    assert torch.equal(best, best_p)
    assert float(((met - met_p).abs() / met_p.abs()).max()) <= 1e-5
    assert np.array_equal(got[~noisy], want[~noisy])
    if noisy.any():
        assert np.mean(got[noisy] != want[noisy]) <= 1e-3
    if got.shape[1] >= 64 + 2 * 510:
        slots, bits2 = demod_fused.demodulate_hard_slots_ri_pallas(
            re, im, 2, phase_bit=64)
        assert np.array_equal(bits2.cpu().numpy(), got)
        assert slots.data_ptr() == bits2.data_ptr() + 64
        assert np.array_equal(slots.cpu().numpy().reshape(len(got), -1),
                              got[:, 64:64 + 2 * 510])


def test_k5_phase_ties():
    """Ties and near-ties of the phase pick: an all-zero carrier (both
    sums 0) picks phase 0, as torch.argmax's first maximum; noise-only
    carriers (sums a hair apart) pick the larger of the kernel's own
    sums, and the plain version's phase wherever the plain sums differ
    by more than 1e-5 relative."""
    dev = cuda_device()
    rng = np.random.default_rng(8)
    re = rng.standard_normal((6, 3_000)).astype(np.float32)
    im = rng.standard_normal((6, 3_000)).astype(np.float32)
    re[0] = im[0] = 0
    re, im = torch.as_tensor(re, device=dev), torch.as_tensor(im, device=dev)
    _, best, met = demod_fused.demod_fused(re, im)
    _, best_p, met_p = demod_fused.demod_fused_plain(re, im)
    assert int(best[0]) == 0 and float(met[0].abs().max()) == 0.0
    assert torch.equal(best, (met[:, 1] > met[:, 0]).long())
    gap = (met_p[:, 0] - met_p[:, 1]).abs() / met_p.amax(1).clamp(min=1e-30)
    sure = gap > 1e-5
    assert torch.equal(best[sure], best_p[sure])


def test_k5_copy_paths():
    """K5 copies its window 16 bytes at a time where every row is
    16-byte aligned (T % 4 == 0, aligned planes) and 4 bytes otherwise:
    planes one float into their storage take the 4-byte copies and give
    exactly the bits, pick and sums of an aligned copy."""
    dev = cuda_device()
    re, im = steady_fixture.capture(8, noisy=range(4, 8), seed=7)
    outs = []
    for shift in (0, 1):
        planes = []
        for x in (re[:, :6_000], im[:, :6_000]):
            flat = torch.zeros(x.size + shift, device=dev)
            flat[shift:] = torch.as_tensor(np.ascontiguousarray(x).ravel(),
                                           device=dev)
            planes.append(flat[shift:].view(x.shape))
        assert (planes[0].data_ptr() % 16 == 0) == (shift == 0)
        outs.append(demod_fused.demod_fused(*planes))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_k5_rejects_bad_arguments():
    dev = cuda_device()
    x = torch.zeros((2, 600), device=dev)
    with pytest.raises(TypeError):
        demod_fused.demod_fused(x.double(), x.double())
    with pytest.raises(ValueError):
        demod_fused.demod_fused(x, x.cpu())
    for sps in (0, 12):
        with pytest.raises(ValueError):
            demod_fused.demod_fused(x, x, sps=sps)
    with pytest.raises(ValueError):
        demod_fused.demod_fused(x, x[:1])
    with pytest.raises(ValueError):
        demod_fused.demod_fused(x[:, ::2], x[:, ::2])
    with pytest.raises(ValueError):
        demod_fused.demodulate_hard_slots_ri_pallas(x, x, 1, phase_bit=3)


def test_steady_chain_launches_k5_and_k1():
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    from tetra_tpu_torch.ops.viterbi_assembled import decode_assembled
    dev = cuda_device()
    fx = steady_fixture.load()
    re, im = steady_fixture.capture(4, fx=fx)
    k5, k1 = demod_fused.demod_fused.launches, decode_assembled.launches
    out = locked_step_ri(torch.as_tensor(re, device=dev),
                         torch.as_tensor(im, device=dev),
                         np.full(4, fx["init"]), phase_bit=64, n_slots=64,
                         fast="pallas", decoders=("fused",))
    assert bool(out["crc_ok"].all())
    assert demod_fused.demod_fused.launches == k5 + 1
    assert decode_assembled.launches == k1 + 1


@pytest.mark.parametrize("sps", list(demod_fused.SPS_RATES))
def test_k5_every_rate_matches_plain(sps):
    """K5 at each rate it is built for: identical bits and phase picks,
    metric sums within 1e-5 relative, on clean random-bit carriers at a
    length no multiple of the tile or of sps."""
    dev = cuda_device()
    bits = np.random.default_rng(sps).integers(0, 2, (5, 2 * 3001))
    iq = dqpsk.modulate(bits.astype(np.uint8), sps=sps)[:, :-1]
    re = torch.as_tensor(iq.real.astype(np.float32), device=dev)
    im = torch.as_tensor(iq.imag.astype(np.float32), device=dev)
    got, best, met = demod_fused.demod_fused(re, im, sps)
    want, best_p, met_p = demod_fused.demod_fused_plain(re, im, sps)
    assert torch.equal(got, want) and torch.equal(best, best_p)
    assert float(((met - met_p).abs() / met_p.abs()).max()) <= 1e-5


def test_eq_chain_on_card_matches_cpu():
    """locked_step_ri(fast="eq") on two carriers of the degraded capture:
    kinds and crc_ok identical to the CPU's, the slots it decodes too."""
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    dev = cuda_device()
    fx = steady_fixture.load()
    re, im = steady_fixture.eq_capture(8, [1, 6], fx=fx)
    outs = [locked_step_ri(torch.as_tensor(re, device=d),
                           torch.as_tensor(im, device=d),
                           np.full(2, fx["init"]), phase_bit=64, n_slots=64,
                           fast="eq", decoders=("fused",))
            for d in (dev, torch.device("cpu"))]
    on = outs[1]["kinds"] >= 0
    assert torch.equal(outs[0]["kinds"].cpu(), outs[1]["kinds"])
    assert torch.equal(outs[0]["crc_ok"].cpu(), outs[1]["crc_ok"])
    assert torch.equal(outs[0]["bits"].cpu().reshape(2, 64, 510)[on],
                       outs[1]["bits"].reshape(2, 64, 510)[on])


def test_early_fetch_on_card_matches_cpu():
    """The bundle's early fetch (pinned buffer + event) on the card: every
    collected field equals the CPU pipeline's, fetched or not, and the
    pinned buffer returns to the free list for the next fetch."""
    from tetra_tpu_torch import prod_fixture
    from tetra_tpu_torch.fastpath import FastChunkPipeline
    dev = cuda_device()
    bits, _ = prod_fixture.mixed_bits(8, 0.25)
    cuts = np.linspace(0, 16_000, 5).astype(int)
    card, cpu = FastChunkPipeline(8, dev), FastChunkPipeline(8, "cpu")
    pending, got, want = [], [], []
    for k in range(4):
        chunk = bits[:, cuts[k]:cuts[k + 1]]
        if pending:
            card.prefetch(pending[0])
            card.prefetch(pending[0])        # a second call copies nothing
        h = card.submit(chunk)
        if h is not None:
            pending.append(h)
        hc = cpu.submit(chunk)
        if hc is not None:
            want.append(cpu.collect(hc))
        if len(pending) > 1:
            got.append(card.collect(pending.pop(0)))
            assert len(card._pinned) == 1
    got += [card.collect(h) for h in pending]
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        for key in b:
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("tol", [0, 2])
@pytest.mark.parametrize("B", [1, 3, 1023, 4097])
@pytest.mark.parametrize("steps", [0, 1, 146])
def test_s1_matches_plain(steps, B, tol):
    """S1 (csrc/sync_scan.cu) against sync_scan_plain on the card: every
    OUT_KEYS plane (values and type) and the carry equal, on production
    rows with bit errors, a garbage span, and KNOW_FSTART carries whose
    frame start lies before the buffer start (or at -1)."""
    dev = cuda_device()
    bits, carry = sync_case(B, steps, 100 * B + steps + tol, dev, n_kf=3)
    res = sync_compare((bits, *carry, 64, steps), {"tol": tol})
    assert res["differ"] == [], res
    if steps == 146 and B >= 1023:
        assert res["emitted"] > 0


def test_s1_rejects_bad_arguments():
    """A non-contiguous, wrong-type or off-card input raises; nothing is
    copied in silence."""
    from tetra_tpu_torch.phy.sync_vec import sync_scan
    dev = cuda_device()
    bits, carry = sync_case(4, 8, 1, dev)
    with pytest.raises(ValueError, match="contiguous"):
        sync_scan(bits.T.contiguous().T, *carry, 0, 8)
    with pytest.raises(ValueError, match="contiguous"):
        sync_scan(bits[:, ::2], *carry, 0, 8)
    for dtype in (torch.uint8, torch.int32, torch.bool):
        with pytest.raises(TypeError):
            sync_scan(bits.to(dtype), *carry, 0, 8)
    with pytest.raises(ValueError, match="carry"):
        sync_scan(bits, *(c.cpu() for c in carry), 0, 8)
    with pytest.raises(ValueError, match="carry"):
        sync_scan(bits, *(c[:3] for c in carry), 0, 8)


def test_s1_launch_count_does_not_grow_with_steps():
    """One sync_scan call on the card over one window: one S1 launch, and
    the same number of device kernels (torch.profiler) at 1, 37 and 146
    steps."""
    from torch.profiler import ProfilerActivity, profile
    from tetra_tpu_torch.phy.sync_vec import sync_scan
    dev = cuda_device()
    bits, carry = sync_case(256, 146, 5, dev)
    counts = []
    for steps in (1, 37, 146):
        sync_scan(bits, *carry, 0, steps)                        # warm
        torch.cuda.synchronize()
        before = sync_scan.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync_scan(bits, *carry, 0, steps)
            torch.cuda.synchronize()
        assert sync_scan.launches - before == 1
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum("sync_scan" in nm for nm in names) == 1, names
        counts.append(len(names))
    assert counts[0] == counts[1] == counts[2], counts


M1_OFFSETS = np.array([-31_400.0, 413_700.25], np.float32)


def _m1_planes(T: int, seed: int, dev):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(T, generator=g).to(dev),
            torch.randn(T, generator=g).to(dev))


def _m1_err(got, want) -> float:
    """max|got - want| over both planes, as a share of max|want|."""
    d = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return d / max(float(w.abs().max()) for w in want)


@pytest.mark.parametrize("base", [0, 100_000, (1 << 24) + 7])
@pytest.mark.parametrize("fs", [1.8e6, 2.4e6, 2.048e6])
def test_m1_matches_plain(fs, base):
    """M1 (csrc/mixer_bank.cu) against channelize_ri_plain on the card
    within 1e-5 of max|plain|, on feeds from shorter than the FIR to a
    few of the mixer stream's BLOCKs, 2 carriers; channelize_ri's
    dispatch returns M1's planes."""
    from tetra_tpu_torch.phy import channelizer as ch
    from tetra_tpu_torch.rx_multi import mixer_block
    dev = cuda_device()
    block = mixer_block(fs)[0]
    for T in (60, 126, 1_000, block + 3, 3 * block + 77):
        re, im = _m1_planes(T, T + base % 11, dev)
        want = ch.channelize_ri_plain(re, im, M1_OFFSETS, fs, base=base)
        got = ch.mixer_bank(re, im, M1_OFFSETS, fs, base=base)
        assert [g.shape for g in got] == [w.shape for w in want], T
        if want[0].numel():
            assert _m1_err(got, want) <= 1e-5, (T, _m1_err(got, want))
        via = ch.channelize_ri(re, im, M1_OFFSETS, fs, base=base)
        assert all(torch.equal(a, b) for a, b in zip(via, got))


def test_m1_matches_plain_at_the_rtl64_shape():
    """The rtl64 cell's large call: 64 carriers 1,370 Hz off the 25 kHz
    grid, 904,100 samples at 1.8 MS/s, a continuation's base."""
    from tetra_tpu_torch.phy import channelizer as ch
    dev = cuda_device()
    offsets = (25_000.0 * (np.arange(64) - 32) + 1_370.0).astype(np.float32)
    re, im = _m1_planes(904_100, 3, dev)
    want = ch.channelize_ri_plain(re, im, offsets, 1.8e6, base=895_900)
    got = ch.mixer_bank(re, im, offsets, 1.8e6, base=895_900)
    assert got[0].shape == want[0].shape == (64, 18_081)
    assert _m1_err(got, want) <= 1e-5, _m1_err(got, want)


def test_m1_demod_bits_equal_on_mixer64():
    """mixer-64's capture (prod_fixture.mixer_capture, 64 off-grid
    carriers at 1.8 MS/s) in one call: M1's channels within 1e-5 of the
    plain path's, and demodulate_hard_ri's bits equal."""
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.io.sdr import RtlTcpSource
    from tetra_tpu_torch.phy import channelizer as ch
    dev = cuda_device()
    fx, fxm = P.load(), P.load_mixer()
    bits = P.mixed_bits(P.MIXER_CARRIERS, 0.1, fx)[0][fxm["mixer_rows"]]
    iq = RtlTcpSource._to_complex(P.mixer_capture(bits, fxm["mixer_bins"]))
    re = torch.as_tensor(np.real(iq).astype(np.float32), device=dev)
    im = torch.as_tensor(np.imag(iq).astype(np.float32), device=dev)
    offsets = fxm["mixer_offsets"]
    want = ch.channelize_ri_plain(re, im, offsets, P.MIXER_FS)
    got = ch.mixer_bank(re, im, offsets, P.MIXER_FS)
    assert _m1_err(got, want) <= 1e-5, _m1_err(got, want)
    assert torch.equal(dqpsk.demodulate_hard_ri(*got, sps=2, os=4),
                       dqpsk.demodulate_hard_ri(*want, sps=2, os=4))


def test_m1_second_call_copies_nothing_to_the_card():
    """After a key's first call, a channelize_ri call on the card is one
    M1 launch: no other kernel, no copy (torch.profiler), and mixer.fused
    counted."""
    from torch.profiler import ProfilerActivity, profile
    from tetra_tpu_torch.phy import channelizer as ch
    from tetra_tpu_torch.utils import trace
    dev = cuda_device()
    re, im = _m1_planes(50_000, 9, dev)
    offsets = np.array([-61_400.0, 13_700.0, 250_000.0], np.float32)
    ch.channelize_ri(re, im, offsets, 1.8e6, base=7)
    torch.cuda.synchronize()
    before = ch.mixer_bank.launches
    trace.reset()
    trace.set_level(1)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ch.channelize_ri(re, im, offsets, 1.8e6, base=50_007)
            torch.cuda.synchronize()
        counts = trace.counters()
    finally:
        trace.set_level(0)
    assert ch.mixer_bank.launches - before == 1
    assert counts.get("mixer.fused") == 1 and "mixer.plain" not in counts
    dev_names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(dev_names) == 1 and "mixer_bank" in dev_names[0], dev_names
    assert not [e.name for e in prof.events()
                if "Memcpy" in e.name or "StreamSynchronize" in e.name]


def test_m1_non_rational_rate_counts_plain():
    """A rate whose fs/36k is not L/M with M <= 64 takes the plain path
    on the card: mixer.plain counted, no M1 launch."""
    from tetra_tpu_torch.phy import channelizer as ch
    from tetra_tpu_torch.utils import trace
    dev = cuda_device()
    re, im = _m1_planes(20_000, 4, dev)
    before = ch.mixer_bank.launches
    trace.reset()
    trace.set_level(1)
    try:
        out = ch.channelize_ri(re, im, M1_OFFSETS, 150_001.0)
        counts = trace.counters()
    finally:
        trace.set_level(0)
    assert counts.get("mixer.plain") == 1 and "mixer.fused" not in counts
    assert ch.mixer_bank.launches == before
    assert out[0].device.type == "cuda" and out[0].shape[0] == 2


def test_m1_rejects_bad_arguments():
    from tetra_tpu_torch.phy.channelizer import mixer_bank
    dev = cuda_device()
    x = torch.zeros(5_000, device=dev)
    with pytest.raises(TypeError):
        mixer_bank(x.double(), x.double(), M1_OFFSETS, 1.8e6)
    with pytest.raises(ValueError):
        mixer_bank(x, x[:4_000], M1_OFFSETS, 1.8e6)
    with pytest.raises(ValueError):
        mixer_bank(x, x.cpu(), M1_OFFSETS, 1.8e6)
    with pytest.raises(ValueError, match="contiguous"):
        mixer_bank(x[::2], x[::2], M1_OFFSETS, 1.8e6)
    with pytest.raises(ValueError):
        mixer_bank(x[None], x[None], M1_OFFSETS, 1.8e6)
    with pytest.raises(ValueError, match="L / M"):
        mixer_bank(x, x, M1_OFFSETS, 150_001.0)
