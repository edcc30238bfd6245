"""The fused chunk program of the PyTorch port vs tetra_tpu.fastpath on
the CPU: identical bundle bytes, traffic payloads (t4_full, t4_b2) and
collect() dicts chunk by chunk, on the packed-bits and the wideband-IQ
entries, hard and soft, through a forced row-budget overflow re-run, and
when resuming from a JAX pipeline's carry (carry_from_numpy)."""
import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import n, CPU
from tests.test_sync_vec import make_stream

from tetra_tpu import fastpath as j_fp

from tetra_tpu_torch import fastpath as t_fp, prod_fixture
from tetra_tpu_torch.rx_multi import pfb_demod_bits_len


def _batch(B, seed, n_frames=3):
    streams = [make_stream(seed + b, n_frames=n_frames) for b in range(B)]
    L = min(len(s) for s in streams)
    return np.stack([s[:L] for s in streams]).astype(np.uint8)


def _same_collect(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _same_t4(ht, hj):
    """Traffic payloads of a collected chunk (after any re-run)."""
    assert np.array_equal(n(ht.t4_full), np.asarray(hj.t4_full))
    assert np.array_equal(n(ht.t4_b2), np.asarray(hj.t4_b2))


def _drive(batch, cuts, jp, tp, check_bundle=True):
    """Submit the same chunks to both pipelines; collect and compare."""
    hs = []
    for k in range(len(cuts) - 1):
        part = batch[:, cuts[k]:cuts[k + 1]]
        hj, ht = jp.submit(part), tp.submit(part)
        assert (hj is None) == (ht is None)
        if hj is not None:
            if check_bundle:
                assert np.array_equal(n(ht.bundle), np.asarray(hj.bundle))
            hs.append((hj, ht))
    for hj, ht in hs:
        _same_collect(tp.collect(ht), jp.collect(hj))
        _same_t4(ht, hj)
    return hs


def test_bits_chunks_bundle_identical():
    """Relocking, corrupted streams over uneven cuts (incl. a chunk
    shorter than one feed quantum)."""
    batch = _batch(8, 7000, n_frames=4)
    L = batch.shape[1]
    cuts = [0, 30, 2100, 2140, L // 2 + 77, L]
    _drive(batch, cuts, j_fp.FastChunkPipeline(8),
           t_fp.FastChunkPipeline(8, CPU))


def test_budget_overflow_rerun(monkeypatch):
    """G_SLACK forced below the emit rate: both pipelines overflow,
    re-run with the sufficient budget and propagate the corrected
    scrambling codes through the later chunk."""
    monkeypatch.setattr(j_fp, "G_SLACK", -4)
    monkeypatch.setattr(t_fp, "G_SLACK", -4)
    batch = prod_fixture.mixed_bits(4, 0.25)[0][:, :9000]
    jp, tp = j_fp.FastChunkPipeline(4), t_fp.FastChunkPipeline(4, CPU)
    hs = _drive(batch, [0, 3000, 6000, 9000], jp, tp)
    assert any(ht.g_rows == 4 * ht.maxs for _, ht in hs[:-1])   # re-ran
    assert [ht.g_rows for _, ht in hs] == [hj.g_rows for hj, _ in hs]
    assert np.array_equal(n(tp.state.carry[4]),
                          np.asarray(jp.carry[4]).astype(np.int64))


def test_resume_from_jax_carry():
    """Run chunk 1 in JAX, hand its state over with carry_from_numpy,
    and run chunk 2 in both: identical bundle and decode."""
    batch = _batch(6, 4200)
    L = batch.shape[1]
    jp = j_fp.FastChunkPipeline(6)
    jp.collect(jp.submit(batch[:, :L // 2]))
    tp = t_fp.FastChunkPipeline(6, CPU)
    tp.state = t_fp.carry_from_numpy(
        np.asarray(jp.ring), tuple(np.asarray(c) for c in jp.carry),
        jp.carry_base, jp.end, jp.fed, "cpu")
    hj, ht = jp.submit(batch[:, L // 2:]), tp.submit(batch[:, L // 2:])
    assert np.array_equal(n(ht.bundle), np.asarray(hj.bundle))
    _same_collect(tp.collect(ht), jp.collect(hj))
    _same_t4(ht, hj)
    assert np.array_equal(n(tp.state.ring), np.asarray(jp.ring))


@pytest.mark.parametrize("soft", [False, True])
def test_wideband_chunk_identical(soft):
    """fused_chunk_iq: the wideband entry (dequantize -> PFB -> resample
    -> demod -> chunk program) gives the JAX bundle bytes and traffic
    payloads on an 8-carrier production capture, on a first and a
    continuation chunk, with the hard and the soft demod."""
    bits, _ = prod_fixture.mixed_bits(8, 0.25)
    packed = prod_fixture.wideband_capture(bits[:, :12000])
    n_chan, fs = 8, 2e5
    BLOCK = 25 * n_chan
    u1 = (len(packed) // 2 // BLOCK) * BLOCK
    feeds = [packed[:u1], packed[u1 - 2 * BLOCK:(len(packed) // BLOCK)
                                 * BLOCK]]
    nb0 = pfb_demod_bits_len(len(feeds[0]), n_chan, fs, 2)
    g = nb0 - 36 * (u1 // BLOCK - 2)
    keeps = [nb0, pfb_demod_bits_len(len(feeds[1]), n_chan, fs, 2) - g]
    jp = j_fp.FastChunkPipeline(8, soft=soft)
    tp = t_fp.FastChunkPipeline(8, CPU, soft=soft)
    chans = np.arange(8, dtype=np.int32)
    for feed, keep in zip(feeds, keeps):
        hj = jp.submit_iq(feed, "iq4c", keep, jnp.asarray(chans), n_chan, fs)
        ht = tp.submit_iq(feed, "iq4c", keep, None, n_chan, fs)
        d, dj = tp.collect(ht), jp.collect(hj)
        _same_t4(ht, hj)
        if soft:
            # the soft demod's values may differ by 1 in rare positions
            # (the bound of tests/test_torch_soft.py); a CRC-failed row's
            # decoded payload can then differ, so hold the rest
            dj.pop("payload"), d.pop("payload")
        else:
            assert np.array_equal(n(ht.bundle), np.asarray(hj.bundle))
        _same_collect(d, dj)
        assert d["okA"].sum() > 0 and (d["kind"] > 0).sum() > 0


@pytest.mark.parametrize("Lc", [33, 64, 100])
def test_pack_and_absorb(Lc):
    bits = np.random.default_rng(Lc).integers(0, 2, (3, Lc)).astype(np.uint8)
    lc_pad = -(-Lc // 32) * 32
    import torch
    got = t_fp._pack_bits_device(torch.as_tensor(bits), lc_pad)
    want = j_fp._pack_bits_device(jnp.asarray(bits), lc_pad)
    assert np.array_equal(n(got), np.asarray(want))
    ring = np.random.default_rng(1).integers(0, 2, (3, t_fp.RING_PAD)) \
        .astype(np.int8)
    assert np.array_equal(
        n(t_fp._absorb(torch.as_tensor(ring), got, Lc, lc_pad)),
        np.asarray(j_fp._absorb(jnp.asarray(ring), want, np.int32(Lc),
                                lc_pad)))
