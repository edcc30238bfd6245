"""Kernel K2's algorithm (csrc/pfb_wola.cu) on the CPU: its FFT plan and
twiddle table (pfb._fft_plan) against the C-point twiddles, and a numpy
model of the kernel (hop rows walked per column, Stockham passes from
the plan and its table, hop rotation) against the port's plain version
and tetra_tpu's Pallas kernel in interpret mode."""
import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import t, n

from tetra_tpu.phy.pfb_pallas import pfb_channelize_rows_pallas

from tetra_tpu_torch.phy import pfb


def k2_model(re, im, h, n_chan: int, J: int = 16):
    """The kernel's arithmetic in numpy (float64): lo/hi window sums over
    hop rows, the plan's radix passes with its table, the (-1)^(m·c)
    sign. re, im [T] -> y [M, C] complex."""
    hop = n_chan // 2
    M = (len(re) - n_chan * J) // hop + 1
    u = (re + 1j * im)[: (M + 2 * J - 1) * hop].reshape(-1, hop)
    h2 = np.asarray(h, np.float64).reshape(J, 2, hop)
    lo = sum(u[2 * j:2 * j + M] * h2[j, 0] for j in range(J))
    hi = sum(u[2 * j + 1:2 * j + 1 + M] * h2[j, 1] for j in range(J))
    x = np.concatenate([lo, hi], 1)
    radices, table = pfb._fft_plan(n_chan)
    w = table[:, 0] - 1j * table[:, 1]
    Ns, off = 1, 0
    for p, R in enumerate(radices):
        per = n_chan // R
        j = np.arange(per)[:, None]
        r = np.arange(R)[None, :]
        v = x[:, j + r * per]                             # [M, per, R]
        if p:
            v = v * w[off + r * Ns + (j % Ns)]
            off += R * Ns
        v = np.fft.fft(v, axis=-1)                        # radix-R DFT
        y = np.empty_like(x)
        y[:, (j // Ns) * Ns * R + j % Ns + r * Ns] = v
        x, Ns = y, Ns * R
    m = np.arange(M)[:, None]
    c = np.arange(n_chan)[None, :]
    return x * np.where((m & c) & 1, -1.0, 1.0)


@pytest.mark.parametrize("n_chan", [8, 12, 16, 64, 1024, 4096])
def test_k2_fft_plan_table(n_chan):
    """Radices: 32 while 32 divides what is left, then the rest (none for
    C not a power of two). Table entry [r·Ns + i] of pass p > 0 is the
    C-point twiddle (PfbFrontEnd.twc/tws) at e = i·r·C/(Ns·R), and that
    is exp(-2πi·i·r/(Ns·R)) to f32 rounding."""
    fe = pfb.PfbFrontEnd(n_chan, 25_000.0 * n_chan)
    radices, table = pfb._fft_plan(n_chan)
    if n_chan & (n_chan - 1):
        assert radices == () and table.shape == (0, 2)
        return
    assert int(np.prod(radices)) == n_chan
    assert all(r == 32 for r in radices[:-1]) and radices[-1] <= 32
    twc, tws = n(fe.twc), n(fe.tws)
    Ns, off = radices[0], 0
    for R in radices[1:]:
        r, i = np.meshgrid(np.arange(R), np.arange(Ns), indexing="ij")
        e = (i * r * (n_chan // (Ns * R))).ravel()
        got = table[off:off + R * Ns]
        assert np.array_equal(got[:, 0], twc[e])
        assert np.array_equal(got[:, 1], tws[e])
        ang = 2 * np.pi * (i * r).ravel() / (Ns * R)
        np.testing.assert_allclose(got[:, 0], np.cos(ang), atol=1e-7)
        np.testing.assert_allclose(got[:, 1], np.sin(ang), atol=1e-7)
        off, Ns = off + R * Ns, Ns * R
    assert off == len(table)


@pytest.mark.parametrize("n_chan,n_frames", [(8, 300), (16, 32), (64, 32),
                                             (1024, 32), (4096, 32)])
def test_k2_model_vs_plain_and_pallas(n_chan, n_frames):
    """The kernel's algorithm (k2_model) == the plain version and the
    Pallas kernel in interpret mode at f32: within 1e-5 x max|plain|
    (the plain version's and the model's sums run in other orders).
    Frame counts the Pallas kernel reads right: its window spans two
    tiles of min(256, M) rows and the next tile's view is clipped to
    the last one, so M must be 32, or >= 256 with its last tile ending
    more than 31 frames short of the grid (ROADMAP §3)."""
    T = 16 * n_chan + (n_frames - 1) * n_chan // 2
    rng = np.random.default_rng(n_chan)
    re = rng.standard_normal(T).astype(np.float32)
    im = rng.standard_normal(T).astype(np.float32)
    fe = pfb.PfbFrontEnd(n_chan, 25_000.0 * n_chan)
    y = k2_model(re.astype(np.float64), im.astype(np.float64), n(fe.h),
                 n_chan)
    pr, pi = (n(a) for a in pfb.pfb_channelize_rows(
        t(re), t(im), fe.h, fe.twc, fe.tws, n_chan, fe.J))
    jr, ji = (np.asarray(a)[:n_frames] for a in pfb_channelize_rows_pallas(
        jnp.asarray(re), jnp.asarray(im), n_chan, interpret=True,
        dft_bf16=False))
    assert pr.shape == y.shape == (n_frames, n_chan)
    tol = 1e-5 * np.abs(pr).max()
    for ref_r, ref_i in ((pr, pi), (jr, ji)):
        assert np.abs(y.real - ref_r).max() <= tol
        assert np.abs(y.imag - ref_i).max() <= tol
