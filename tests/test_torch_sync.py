"""Burst synchroniser of the PyTorch port vs tetra_tpu.phy.sync_vec:
every per-step output and the final carry bit-exact, on corrupted
relocking streams scanned in uneven chunks."""
import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import t, n
from tests.test_sync_vec import make_stream

from tetra_tpu.phy import burst as j_burst, sync_vec as j_sv

from tetra_tpu_torch.phy import burst
from tetra_tpu_torch.phy.sync_vec import sync_scan, OUT_KEYS


def test_train_seq_match():
    bits = np.stack([make_stream(s, n_frames=2)[:3000] for s in range(4)])
    got = n(burst.train_seq_match(t(bits), j_sv._MASK))
    want = np.asarray(j_burst.train_seq_match(jnp.asarray(bits), j_sv._MASK))
    assert np.array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_sync_scan_chunked(seed):
    """Carry the state across three uneven chunks of a window, as the
    fast path does; compare every step's outputs and the carries."""
    B = 6
    streams = [make_stream(100 * seed + b, n_frames=3) for b in range(B)]
    L = min(len(s) for s in streams)
    bits = np.stack([s[:L] for s in streams]).astype(np.int8)
    rng = np.random.default_rng(seed)
    z = np.zeros(B, np.int32)
    jc = (z, z, z, z, z)
    tc = tuple(t(z) for _ in range(5))
    fed = 0
    for steps in (int(rng.integers(10, 40)), int(rng.integers(10, 40)),
                  (L - 64 * 80) // 64):
        (js, jb, jn, jf, ji, jfed), jout = j_sv.sync_scan(
            jnp.asarray(bits), *map(jnp.asarray, jc), np.int32(fed), steps)
        (ts, tb, tn, tf, ti, tfed), tout = sync_scan(t(bits), *tc, fed,
                                                     steps)
        for k in OUT_KEYS:
            assert np.array_equal(n(tout[k]), np.asarray(jout[k])), k
        for a, b in zip((ts, tb, tn, tf, ti), (js, jb, jn, jf, ji)):
            assert np.array_equal(n(a), np.asarray(b))
        assert tfed == int(jfed)
        jc = (js, jb, jn, jf, ji * 0)
        tc = (ts, tb, tn, tf, ti * 0)
        fed = tfed
    assert n(tout["emit"]).sum() > 0 and n(tout["lost"]).sum() >= 0
