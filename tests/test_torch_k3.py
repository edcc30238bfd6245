"""Kernel K3's algorithm (csrc/resample_rows.cu) on the CPU: a numpy model
of the kernel's tiling (stage shapes, blocks owning runs of stages of a
channel tile, windows loaded with masked rows and channel tails, the
subset read, both output layouts) against the port's plain versions and
tetra_tpu's Pallas resampler in interpret mode (f32); the front end with
a channel subset against the Pallas composition; and the conv2d
yardstick chip_smoke.py times beside the kernel."""
import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import t, n

from tetra_tpu.phy.pfb_pallas import (pfb_channelize_rows_pallas,
                                      resample_rows_pallas)

from chip_smoke import k3_library
from tetra_tpu_torch.phy import pfb

# csrc/resample_rows.cu
KCT, STAGE_Q, RUN, SMEM_TARGET, SMEM_MAX = 32, 4, 2, 76 * 1024, 227 * 1024


def shape_of(L: int, M: int, NT: int, width: int, cm: bool):
    """The kernel's stage shape (SQ q-blocks, R window rows, TP tile
    stride, shared bytes), as shape_of in the source."""
    for SQ in range(STAGE_Q, 0, -1):
        R = (SQ - 1) * L + width
        TP = (SQ * M) | 1
        smem = 4 * (4 * R * KCT + (2 * KCT * TP if cm else 0) + M * NT + M)
        if smem <= SMEM_TARGET or (SQ == 1 and smem <= SMEM_MAX):
            return SQ, R, TP, smem
    raise AssertionError("no stage shape fits")


def k3_model(xr, xi, fe, n_out: int, channel_major: bool, idx=None):
    """The kernel's arithmetic in numpy: block b owns channel tile
    b % n_tiles and the run of RUN stages from (b // n_tiles)·RUN; each
    stage loads its window of R rows x 32 channels from input row
    stage·SQ·L + bmin (zeros outside [0, n_in) and past the last
    channel, columns `idx` read in place), sums each output's NT live
    taps from it, and stores the stage time-major or through the
    transposed [2, 32, TP] tile. Returns (yr, yi) and how often each
    output was written."""
    taps, off = n(fe.rs_taps), n(fe.rs_off)
    L, M, NT, width, bmin = fe.L, fe.M, taps.shape[1], fe.W.shape[0], \
        fe.bmin
    n_in, C = xr.shape
    cols = np.arange(C) if idx is None else np.asarray(idx)
    c_sel = len(cols)
    SQ, R, TP, _ = shape_of(L, M, NT, width, channel_major)
    assert (TP % 2, TP >= SQ * M) == (1, True)
    # every tap row lies inside the window: off[r] - bmin + NT <= width
    assert ((off - bmin) + NT <= width).all() and (off >= bmin).all()
    n_q = SQ * M
    n_tiles = -(-c_sel // KCT)
    n_stages = -(-(-(-n_out // M)) // SQ)
    n_blocks = -(-n_stages // RUN) * n_tiles
    shape = (c_sel, n_out) if channel_major else (n_out, c_sel)
    y = np.zeros((2,) + shape, np.float64)
    hits = np.zeros(shape, np.int64)
    planes = np.stack([xr, xi]).astype(np.float64)
    for b in range(n_blocks):
        s0 = b // n_tiles * RUN
        for stage in range(s0, min(s0 + RUN, n_stages)):
            c0 = b % n_tiles * KCT
            g = stage * SQ * L + bmin + np.arange(R)
            ch = c0 + np.arange(KCT)
            live = ((g >= 0) & (g < n_in))[:, None] & (ch < c_sel)[None]
            src = planes[:, np.clip(g, 0, n_in - 1)][
                :, :, cols[np.minimum(ch, c_sel - 1)]]
            win = np.where(live, src, 0.0)                  # [2, R, 32]
            o0 = stage * n_q
            tile = np.zeros((2, KCT, TP))
            for ol in range(n_q):
                q, r = divmod(ol, M)
                base = q * L + off[r] - bmin
                acc = np.einsum("t,ptc->pc", taps[r], win[:, base:base + NT])
                if channel_major:
                    tile[:, :, ol] = acc
                else:
                    o, keep = o0 + ol, ch < c_sel
                    if o < n_out:
                        y[:, o, ch[keep]] = acc[:, keep]
                        hits[o, ch[keep]] += 1
            if channel_major:
                n_valid = min(n_q, n_out - o0)
                for h in range(2 * KCT):
                    cc = c0 + h % KCT
                    if cc < c_sel:
                        y[h // KCT, cc, o0:o0 + n_valid] = \
                            tile[h // KCT, h % KCT, :n_valid]
                        hits[cc, o0:o0 + n_valid] += h // KCT == 0
    return y[0], y[1], hits


# n_in below the filter width (31) and not multiples of L = 25: n_out 0,
# 8, 44 (under one stage of 72 outputs) and 308 (five stages)
N_IN = (9, 20, 70, 437)


@pytest.mark.parametrize("n_chan", [8, 12, 16, 40])
@pytest.mark.parametrize("n_in", N_IN)
def test_k3_model_vs_plain_and_pallas(n_chan, n_in):
    """The kernel's tiling (k3_model) in both layouts, and with a
    permuted subset in the channel-major one, == the port's plain
    versions and the Pallas kernel in interpret mode (f32): atol 1e-5;
    every output written exactly once. At n_out 0 the Pallas kernel
    cannot run (its grid would be empty; its block reads fail), so the
    empty outputs are held to the plain versions only."""
    rng = np.random.default_rng(n_chan * 1000 + n_in)
    xr = rng.standard_normal((n_in, n_chan)).astype(np.float32)
    xi = rng.standard_normal((n_in, n_chan)).astype(np.float32)
    fe = pfb.PfbFrontEnd(n_chan, 25_000.0 * n_chan)
    n_out = fe.n_out(n_in)
    if n_out:
        jr, ji = (np.asarray(a) for a in resample_rows_pallas(
            jnp.asarray(xr), jnp.asarray(xi), fe.chan_rate, 36_000.0,
            skew=fe.skew, interpret=True, bf16=False))
    else:
        jr = ji = np.zeros((0, n_chan), np.float32)
    assert jr.shape == (n_out, n_chan)
    pr, pi = (n(a) for a in pfb.resample_rows(
        t(xr), t(xi), fe.rs_taps, fe.rs_off, fe.W, fe.bmin, fe.L, fe.M,
        n_out))
    mr, mi, hits = k3_model(xr, xi, fe, n_out, False)
    assert (hits == 1).all()
    for ref_r, ref_i in ((pr, pi), (jr, ji)):
        np.testing.assert_allclose(mr, ref_r, atol=1e-5, rtol=0)
        np.testing.assert_allclose(mi, ref_i, atol=1e-5, rtol=0)
    idx = rng.permutation(n_chan)[: max(n_chan // 2, 3)]
    for sel in (None, idx):
        cr, ci = (n(a) for a in pfb.resample_rows(
            t(xr), t(xi), fe.rs_taps, fe.rs_off, fe.W, fe.bmin, fe.L, fe.M,
            n_out, channel_major=True,
            channel_idx=None if sel is None else t(sel, None).long()))
        mr, mi, hits = k3_model(xr, xi, fe, n_out, True, sel)
        take = np.arange(n_chan) if sel is None else sel
        assert mr.shape == cr.shape == (len(take), n_out)
        assert (hits == 1).all()
        for ref_r, ref_i in ((cr, ci), (jr.T[take], ji.T[take])):
            np.testing.assert_allclose(mr, ref_r, atol=1e-5, rtol=0)
            np.testing.assert_allclose(mi, ref_i, atol=1e-5, rtol=0)


def test_k3_stage_shape():
    """At the plan every front end uses (L 25, M 18, NT 8, width 31): four
    q-blocks a stage (72 outputs), a 106-row window, a 73-float tile
    row, 73,608 shared bytes channel-major and 54,920 time-major (three
    and four blocks in an SM's 228 KB, with 1 KB reserved a block)."""
    fe = pfb.PfbFrontEnd(1024, 25_600_000.0)
    assert (fe.L, fe.M, fe.W.shape[0], fe.rs_taps.shape[1]) == (25, 18, 31, 8)
    assert shape_of(25, 18, 8, 31, True) == (4, 106, 73, 73_608)
    assert shape_of(25, 18, 8, 31, False) == (4, 106, 73, 54_920)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_front_end_subset_vs_pallas(dtype):
    """pfb_to_demod_rate_ri with the subset [5, 0, 3] (K2's rows read in
    place by the channel-major K3) == the JAX Pallas composition
    pfb_channelize_rows_pallas -> resample_rows_pallas -> take(out.T,
    idx) in interpret mode (f32): atol 1e-5; and the model on the same
    rows."""
    n_chan, T = 8, 30_000
    rng = np.random.default_rng(5)
    re = rng.standard_normal(T).astype(np.float32)
    im = rng.standard_normal(T).astype(np.float32)
    sel = np.asarray([5, 0, 3], dtype)
    ar, ai = (n(a) for a in pfb.pfb_to_demod_rate_ri(
        t(re), t(im), t(sel, None), n_chan, 2e5))
    fe = pfb.PfbFrontEnd(n_chan, 2e5)
    jr, ji = pfb_channelize_rows_pallas(jnp.asarray(re), jnp.asarray(im),
                                        n_chan, interpret=True,
                                        dft_bf16=False)
    pr, pi = resample_rows_pallas(jr, ji, fe.chan_rate, 36_000.0,
                                  skew=fe.skew, interpret=True, bf16=False)
    br, bi = (np.asarray(jnp.take(x.T, jnp.asarray(sel), axis=0))
              for x in (pr, pi))
    assert ar.shape == br.shape == (3, fe.n_out(jr.shape[0]))
    np.testing.assert_allclose(ar, br, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ai, bi, atol=1e-5, rtol=0)
    mr, mi, _ = k3_model(np.asarray(jr), np.asarray(ji), fe, ar.shape[1],
                         True, sel)
    np.testing.assert_allclose(mr, br, atol=1e-5, rtol=0)
    np.testing.assert_allclose(mi, bi, atol=1e-5, rtol=0)


def test_k3_rejects_index_without_channel_major():
    fe = pfb.PfbFrontEnd(8, 2e5)
    x = t(np.zeros((100, 8), np.float32))
    with pytest.raises(ValueError):
        pfb.resample_rows(x, x, fe.rs_taps, fe.rs_off, fe.W, fe.bmin, fe.L,
                          fe.M, 10, channel_idx=t(np.asarray([1])).long())


@pytest.mark.parametrize("n_chan,n_in", [(8, 437), (12, 70), (3, 200)])
def test_conv2d_yardstick_equals_plain(n_chan, n_in):
    """chip_smoke.k3_library (one strided conv2d over the stacked,
    pre-padded planes with W's columns as filters) computes K3's
    function: == resample_rows_plain within 1e-5 on the CPU."""
    rng = np.random.default_rng(n_in)
    xr = t(rng.standard_normal((n_in, n_chan)).astype(np.float32))
    xi = t(rng.standard_normal((n_in, n_chan)).astype(np.float32))
    fe = pfb.PfbFrontEnd(8, 2e5)
    n_out = fe.n_out(n_in)
    call, unpack = k3_library(xr, xi, fe.W, fe.bmin, fe.L, fe.M, n_out)
    got = unpack(call())
    want = pfb.resample_rows_plain(xr, xi, fe.W, fe.bmin, fe.L, fe.M, n_out)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (n_out, n_chan)
        np.testing.assert_allclose(n(a), n(b), atol=1e-5, rtol=0)
