"""The port's two-rank worker (tetra_tpu_torch.parallel.dist_worker) on 2
spawned CPU gloo ranks against tetra_tpu's one-process receiver, as
tests/test_distributed.py holds tetra_tpu's two-process worker: the
stitched 2-D chain shards from per-host time windows, and the fast-path
phase's per-carrier stats and TL-SDU entries, each rank walking only its
own carriers. Then the wideband entries on a carrier mesh of the two
ranks: the mixer bank decodes as tetra_tpu's one-process mixer receiver
(tetra_tpu decodes it on a multi-process mesh too), and the PFB entry
raises (tetra_tpu's fused PFB chunk parses garbage on a multi-process
mesh: its collect_local reads the unsharded bundle as shard segments).

The ranks are spawned once for the module (tests/_torch_ranks.py,
jax-free); each test reads its case from their outputs.
"""
import pathlib
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from tests import _torch_ranks
from tetra_tpu.lmac import steady
from tetra_tpu.rx_multi import MultiCarrierReceiver as JaxReceiver
from tetra_tpu.umac import native_exec

from tetra_tpu_torch.parallel import dist_worker
from tetra_tpu_torch.parallel.launch import launch

RANKS = 2
ROOT = pathlib.Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.skipif(not native_exec.available(),
                                reason="native library unavailable")


@pytest.fixture(scope="module")
def wide():
    """An 8-carrier 200 kHz companded capture (tools/bench_mc_e2e's
    protocol mix), carrier c at FFT bin c, for the mixer bank."""
    sys.path.insert(0, str(ROOT / "tools"))
    import bench_mc_e2e as B
    from tetra_tpu.io import stream as stream_mod
    from tetra_tpu.phy import channelizer, dqpsk
    bits, _ = B.mixed_batch(8, 8, enc_frac=0.25)
    base = dqpsk.modulate(bits, sps=2)
    wb = channelizer.synthesize_wideband_fft(base, np.arange(8), 8)
    u8 = stream_mod.quantize_iq4c(wb.real, wb.imag)
    return {"u8": u8, "cut": len(u8) // 2, "fs": 2e5,
            "offsets": np.fft.fftfreq(8, 1 / 2e5).astype(np.float32)}


@pytest.fixture(scope="module")
def dumps(wide):
    return launch(_torch_ranks.distributed_cases, RANKS, wide, device="cpu",
                  threads=1, timeout=600)


def test_two_rank_2d_chain_matches_single(dumps):
    """Per-host time windows (each rank holds only its own) through the
    halo-exchanged 2-D chain: the stitched shards equal tetra_tpu's
    one-process chain on tools/dist_worker's capture."""
    sys.path.insert(0, str(ROOT))
    from tools.dist_worker import build_capture, CC, S_TOTAL
    re, im, inits = build_capture()
    mine = dist_worker.build_capture("cpu")
    for a, b in zip(mine, (re, im, inits)):
        np.testing.assert_array_equal(a, b)
    ref = steady.locked_step_ri(jnp.asarray(re), jnp.asarray(im),
                                jnp.asarray(inits), phase_bit=0,
                                n_slots=S_TOTAL, decoders=("fused",))
    assert {tuple(sorted(d["coords"].items())) for d in dumps} == \
        {(("chip", 0), ("host", h)) for h in range(RANKS)}
    np.testing.assert_array_equal(dist_worker.stitch_dumps(dumps, "kinds"),
                                  np.asarray(ref["kinds"]))
    np.testing.assert_array_equal(dist_worker.stitch_dumps(dumps, "crc_ok"),
                                  np.asarray(ref["crc_ok"]))
    np.testing.assert_array_equal(
        dist_worker.stitch_dumps(dumps, "schf_type1"),
        np.asarray(ref["schf"].type1))
    want_total = int(np.asarray(ref["crc_ok"]).sum())
    assert want_total == CC * S_TOTAL
    assert {d["crc_ok_total"] for d in dumps} == {want_total}
    # each host held only its own time window of the slots
    assert {d["kinds"].shape for d in dumps} == {(CC, S_TOTAL // RANKS)}


@pytest.fixture(scope="module")
def jax_fast():
    """tetra_tpu's one-process native receiver on the fast-path capture:
    (TL-SDU sink entries, per-carrier (crc_ok, crc_wrong, slots))."""
    sys.path.insert(0, str(ROOT))
    from tools.dist_worker import build_bits_capture
    n_car = dist_worker.FAST_CARRIERS
    bits = build_bits_capture(n_car)
    np.testing.assert_array_equal(
        dist_worker.build_bits_capture(n_car, "cpu"), bits)
    sink = []
    mc = JaxReceiver(
        np.zeros(n_car), fs=25e3 * n_car, control_plane="native",
        tl_sdu_sink=lambda *a: sink.append(dist_worker.sink_entry(*a)))
    L = bits.shape[1]
    cuts = [0, L // 3, 2 * L // 3, L]
    for k in range(3):
        mc.process_bits(bits[:, cuts[k]:cuts[k + 1]], final=k == 2)
    stats = {c: (mc.carriers[c].stats.crc_ok, mc.carriers[c].stats.crc_wrong,
                 mc.carriers[c].stats.slots) for c in range(n_car)}
    return sink, stats


def _by_carrier(entries):
    out = {}
    for e in entries:
        out.setdefault(e[0], []).append(e[1:])
    return out


def test_two_rank_fast_path_sink_matches_single(dumps, jax_fast):
    """Each rank's TL-SDU sink holds only its own carriers, and their
    union equals the one-process receiver's, carrier by carrier."""
    n_car = dist_worker.FAST_CARRIERS
    owned = sorted(c for d in dumps for c in d["fast_owned"])
    assert owned == list(range(n_car))
    for d in dumps:
        assert len(d["fast_owned"]) == n_car // RANKS
        assert {e[0] for e in d["fast_sink"]} <= set(d["fast_owned"])
    got = _by_carrier([e for d in dumps for e in d["fast_sink"]])
    want = _by_carrier(jax_fast[0])
    assert got == want and len(want) == n_car


def test_two_rank_fast_path_stats_match_single(dumps, jax_fast):
    for d in dumps:
        for c, ok, wrong, slots in d["fast_stats"]:
            assert (ok, wrong, slots) == jax_fast[1][c], c
            assert ok > 0 and wrong == 0
    assert sum(len(d["fast_stats"]) for d in dumps) == \
        dist_worker.FAST_CARRIERS


def test_mixer_bank_on_mesh_matches_single(dumps, wide):
    """The mixer bank on a two-rank carrier mesh: each rank's carriers
    decode as tetra_tpu's one-process mixer receiver on the same bytes."""
    mc = JaxReceiver(wide["offsets"], fs=wide["fs"], control_plane="native")
    mc.process_iq4c(wide["u8"][:wide["cut"]], final=False)
    mc.process_iq4c(wide["u8"][wide["cut"]:], final=True)
    want = {c: (r.stats.bursts, r.stats.crc_ok, r.stats.crc_wrong)
            for c, r in enumerate(mc.carriers)}
    got = {c: st for d in dumps for c, st in d["mixer_stats"].items()}
    assert got == want
    assert all(ok > 0 and wrong == 0 for _, ok, wrong in want.values())


def test_pfb_entry_on_mesh_raises(dumps):
    """The PFB wideband entry on a multi-rank mesh raises and names the
    limit, on every rank."""
    for d in dumps:
        assert d["pfb_error"] is not None and "multi-rank" in d["pfb_error"]
