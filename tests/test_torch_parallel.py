"""The port's sharded paths (tetra_tpu_torch.parallel.mesh, the
carrier-sharded fused chunk pipeline and the dry run) on 4 spawned CPU
gloo ranks, against tetra_tpu's sharded functions on the 8 virtual CPU
devices of tests/conftest.py and their unsharded references (the cases
of tests/test_parallel.py and __graft_entry__.dryrun_multichip).

The ranks are spawned once for the module (tests/_torch_ranks.py,
jax-free); each test reads its case from their outputs. Bits, kinds,
CRC flags and bundle fields must be equal; the PFB's f32 outputs within
atol 1e-4, as tests/test_parallel.py allows.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests import _torch_ranks
from tetra_tpu import constants as C, testpdu, tx
from tetra_tpu.fastpath import FastChunkPipeline as JaxPipeline
from tetra_tpu.lmac import pipeline, steady
from tetra_tpu.ops.scramble import scramb_get_init
from tetra_tpu.parallel import mesh as jmesh
from tetra_tpu.phy import burst as burst_mod, dqpsk, pfb

from tetra_tpu_torch.parallel import dryrun
from tetra_tpu_torch.parallel.launch import launch
from tetra_tpu_torch.parallel.mesh import MAX_TRAIN_LEN, stitch

RANKS = 4
INIT = scramb_get_init(262, 42, 1)
AACH = testpdu.make_access_assign_bits()


def _sync():
    return np.asarray(tx.make_sync_burst(
        testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
        testpdu.make_sysinfo_pdu(), AACH, jnp.uint32(INIT)), np.int8)


def _schf(ssi):
    return np.asarray(tx.make_schf_burst(testpdu.make_resource_pdu(ssi=ssi),
                                         AACH, jnp.uint32(INIT)), np.int8)


def _planes(bits):
    iq = dqpsk.modulate(bits.astype(np.int8), sps=2)
    return np.real(iq).astype(np.float32), np.imag(iq).astype(np.float32)


def _inputs() -> dict:
    """The global inputs of every case (tests/test_parallel.py's)."""
    sync = _sync()
    inp = {}
    Cc, S = 16, 2
    bursts = np.zeros((Cc, S, 510), np.int8)
    kinds = np.zeros((Cc, S), np.int32)
    for c in range(Cc):
        for s in range(S):
            kinds[c, s] = (c + s) % 2
            bursts[c, s] = sync if kinds[c, s] == 0 else _schf(c * 10 + s)
    inp["decode"] = {"bursts": bursts, "kinds": kinds,
                     "inits": np.full(Cc, INIT, np.uint32)}
    # a training sequence straddling a shard boundary of the JAX mesh
    # (8 shards of 256) and one of the port's (4 ranks of 512)
    bits = np.random.default_rng(1).integers(0, 2, (2, 8 * 256)).astype(
        np.int8)
    for start in (256 * 3 - 10, 512 * 2 - 10):
        bits[0, start:start + len(C.TRAIN_Y)] = C.TRAIN_Y
    inp["match_bits"] = bits
    Cc, S = 8, 2
    rows = np.stack([np.concatenate([_schf(c * 10 + s) for s in range(S)])
                     for c in range(Cc)])
    pad = np.zeros((Cc, 64), np.int8)
    re, im = _planes(np.concatenate([pad, rows, pad], axis=1))
    inp["chain"] = {"re": re, "im": im, "S": S,
                    "inits": np.full(Cc, INIT, np.uint32)}
    n_chan, J = 16, 16
    rng = np.random.default_rng(5)
    T = 8 * 64 * (n_chan // 2)
    inp["pfb"] = {"n_chan": n_chan, "J": J,
                  "re": rng.normal(0, 1, T).astype(np.float32),
                  "im": rng.normal(0, 1, T).astype(np.float32)}
    rng = np.random.default_rng(3)
    Cc, S_total = 8, 8
    slots = np.zeros((Cc, S_total, 510), np.int8)
    for c in range(Cc):
        for s in range(S_total):
            k = (c + s) % 3
            slots[c, s] = (sync if k == 0 else _schf(c * 16 + s) if k == 1
                           else tx.make_ndb_burst(
                               rng.integers(0, 2, 124).astype(np.int8),
                               rng.integers(0, 2, 124).astype(np.int8),
                               AACH, jnp.uint32(INIT)))
    re, im = _planes(slots.reshape(Cc, -1))
    inp["chain2d"] = {"re": re, "im": im, "S": S_total,
                      "inits": np.full(Cc, INIT, np.uint32)}
    rng = np.random.default_rng(0)
    T = 4 * 255 * 2
    inp["layout2d"] = {"re": rng.normal(0, 1, (4, T)).astype(np.float32),
                       "im": rng.normal(0, 1, (4, T)).astype(np.float32),
                       "inits": np.full(4, 3, np.uint32)}
    fast = dryrun.inputs(RANKS, "cpu")
    inp["fast_bits"], inp["fast_cuts"] = fast["fast_bits"], fast["fast_cuts"]
    return inp


@pytest.fixture(scope="module")
def inp():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inp):
    """Every rank's outputs of every case: one spawn of 4 CPU ranks."""
    return launch(_torch_ranks.parallel_cases, RANKS, inp, device="cpu",
                  threads=1, timeout=600)


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


def _stitch(ranks, key, sub, spec, coords="coords", sizes=None):
    return stitch([(r[coords], r[key][sub] if sub is not None else r[key])
                   for r in ranks], spec,
                  sizes or {"carrier": RANKS, "time": RANKS})


SIZES_2D = {"host": 2, "chip": RANKS // 2}


def test_sharded_decode_matches_jax(ranks, inp, devices):
    d = inp["decode"]
    want = jmesh.sharded_burst_decode(jmesh.make_mesh(devices))(
        jnp.asarray(d["bursts"]), jnp.asarray(d["inits"]),
        jnp.asarray(d["kinds"]))
    for key in want:
        if key == "crc_ok_total":
            assert {int(r["decode"][key]) for r in ranks} == \
                {int(want[key])} == {d["kinds"].size}
            continue
        np.testing.assert_array_equal(
            _stitch(ranks, "decode", key, ("carrier",)),
            np.asarray(want[key]), err_msg=key)
    # and the unsharded decoders on each slot's own kind
    ref = pipeline.decode_schf_burst(jnp.asarray(d["bursts"]),
                                     jnp.asarray(d["inits"])[:, None])
    m1 = d["kinds"] == 1
    np.testing.assert_array_equal(
        _stitch(ranks, "decode", "schf_type1", ("carrier",))[m1],
        np.asarray(ref["SCH_F"].type1)[m1])


def test_halo_exchange_matches_jax(ranks, inp, devices):
    bits = jnp.asarray(inp["match_bits"])
    want = jmesh.sharded_match_map(
        jax.sharding.Mesh(np.asarray(devices), ("time",)))(bits)
    ref = burst_mod.train_seq_match(bits)
    got = _stitch(ranks, "match", None, (None, "time"))
    valid = bits.shape[1] - (MAX_TRAIN_LEN - 1)
    np.testing.assert_array_equal(got[:, :valid], np.asarray(want)[:, :valid])
    np.testing.assert_array_equal(got[:, :valid], np.asarray(ref)[:, :valid])
    assert got[0, 256 * 3 - 10, 0] and got[0, 512 * 2 - 10, 0]


def test_sharded_full_chain_matches_jax(ranks, inp, devices):
    c = inp["chain"]
    args = (jnp.asarray(c["re"]), jnp.asarray(c["im"]),
            jnp.asarray(c["inits"]))
    want = jmesh.sharded_locked_step(jmesh.make_mesh(devices), phase_bit=64,
                                     n_slots=c["S"], decoders=("schf",))(*args)
    ref = steady.locked_step_ri(*args, phase_bit=64, n_slots=c["S"],
                                decoders=("schf",))
    for key in ("kinds", "crc_ok", "schf_type1"):
        np.testing.assert_array_equal(_stitch(ranks, "chain", key,
                                              ("carrier",)),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(
        _stitch(ranks, "chain", "schf_type1", ("carrier",)),
        np.asarray(ref["schf"].type1))
    assert {int(r["chain"]["crc_ok_total"]) for r in ranks} == \
        {int(want["crc_ok_total"])} == {c["re"].shape[0] * c["S"]}


def test_sharded_pfb_matches_jax(ranks, inp, devices):
    p = inp["pfb"]
    re, im = jnp.asarray(p["re"]), jnp.asarray(p["im"])
    want = jmesh.sharded_pfb_channelize(
        jax.sharding.Mesh(np.asarray(devices), ("time",)), p["n_chan"],
        p["J"])(re, im)
    ref = pfb.pfb_channelize_ri(re, im, p["n_chan"], p["J"])
    m_common = np.asarray(ref[0]).shape[-1]
    wrap = (p["n_chan"] * p["J"]) // (p["n_chan"] // 2) + 1
    for i in range(2):
        got = stitch([(r["coords"], r["pfb"][i]) for r in ranks],
                     (None, "time"), {"time": RANKS})
        assert got.shape == np.asarray(want[i]).shape
        np.testing.assert_allclose(got[:, :m_common - wrap],
                                   np.asarray(ref[i])[:, :m_common - wrap],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[:, :m_common - wrap],
                                   np.asarray(want[i])[:, :m_common - wrap],
                                   rtol=0, atol=1e-4)


def test_locked_step_2d_matches_jax(ranks, inp, devices):
    c = inp["chain2d"]
    args = (jnp.asarray(c["re"]), jnp.asarray(c["im"]),
            jnp.asarray(c["inits"]))
    want = jmesh.sharded_locked_step_2d(
        jmesh.make_mesh_2d(devices, hosts=2))(*args)
    ref = steady.locked_step_ri(*args, phase_bit=0, n_slots=c["S"],
                                decoders=("fused",))
    for key in ("kinds", "crc_ok", "schf_type1"):
        got = _stitch(ranks, "chain2d", key, ("chip", "host"), "coords2",
                      SIZES_2D)
        np.testing.assert_array_equal(got, np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(
        _stitch(ranks, "chain2d", "schf_type1", ("chip", "host"), "coords2",
                SIZES_2D), np.asarray(ref["schf"].type1))
    n = c["re"].shape[0] * c["S"]
    assert {int(r["chain2d"]["crc_ok_total"]) for r in ranks} == \
        {int(want["crc_ok_total"])} == {n}


def test_sharding_layout_2d(ranks, inp, devices):
    """Each rank holds its (carriers / chips, slots / hosts) shard, and
    the stitched outputs equal JAX's on random planes."""
    c = inp["layout2d"]
    want = jmesh.sharded_locked_step_2d(jmesh.make_mesh_2d(devices, hosts=2))(
        jnp.asarray(c["re"]), jnp.asarray(c["im"]), jnp.asarray(c["inits"]))
    assert {r["layout2d"]["kinds"].shape for r in ranks} == \
        {(4 // SIZES_2D["chip"], 4 // 2)}
    np.testing.assert_array_equal(
        _stitch(ranks, "layout2d", "kinds", ("chip", "host"), "coords2",
                SIZES_2D), np.asarray(want["kinds"]))


@pytest.mark.parametrize("soft", [False, True])
def test_sharded_fast_path_matches_jax(ranks, inp, devices, soft):
    """The carrier-sharded fused chunk pipeline (collect gathers every
    rank's segment) against tetra_tpu's on its 8-device carrier mesh
    (which tetra_tpu's dry run holds to its unsharded run): every
    collected field equal, chunk by chunk, on every rank."""
    bits, cuts = inp["fast_bits"], inp["fast_cuts"]

    def run(mesh):
        fp = JaxPipeline(bits.shape[0], mesh=mesh, soft=soft)
        outs = []
        for i in range(len(cuts) - 1):
            h = fp.submit(bits[:, cuts[i]:cuts[i + 1]])
            if h is not None:
                outs.append(fp.collect(h))
        return outs

    want = run(jax.sharding.Mesh(np.asarray(devices), ("car",)))
    key = "fast_soft" if soft else "fast"
    assert len(want) > 0
    for r in ranks:
        assert len(r[key]) == len(want)
        for a, b in zip(r[key], want):
            for k in dryrun.FAST_KEYS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sum(int(d["okA"].sum()) for d in want) >= bits.shape[0] * 4


def test_dryrun_matches_unsharded_port(ranks):
    """The dry run's rank outputs on 4 ranks against the port's
    unsharded run (dryrun.check raises on any mismatch)."""
    inp = dryrun.inputs(RANKS, "cpu")
    counts = dryrun.check([r["dryrun"] for r in ranks],
                          dryrun.unsharded(inp, "cpu"), inp)
    assert counts["fast_crc_ok"] >= 2 * RANKS * 4
