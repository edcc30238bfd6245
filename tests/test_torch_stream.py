"""The port's double-buffered ingest loop (tetra_tpu_torch.io.stream.
stream_map) against tetra_tpu.io.stream.stream_map on the same seeded
chunks, on the CPU: with and without `static`, with prefetch 0 and 2,
the same outputs in the same order."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tetra_tpu.io import stream as jstream

from tests._torch_util import CPU, n
from tetra_tpu_torch.io import stream


def _chunks():
    """Seven chunks, each a tree: int8 IQ planes [2, 4, 64] and a uint32
    word per carrier."""
    rng = np.random.default_rng(11)
    return [{"iq": rng.integers(-127, 128, (2, 4, 64)).astype(np.int8),
             "w": rng.integers(0, 2 ** 32, 4, dtype=np.uint64)
             .astype(np.uint32)} for _ in range(7)]


def _jax_step(c, init=None):
    x = c["iq"].astype(jnp.int32)
    out = (x[0] * 3 + x[1]).sum(-1) + (c["w"] & 0xFFFF).astype(jnp.int32)
    return out if init is None else out ^ (init & 0xFFFF).astype(jnp.int32)


def _torch_step(c, init=None):
    x = c["iq"].to(torch.int32)
    out = (x[0] * 3 + x[1]).sum(-1) + (c["w"] & 0xFFFF).to(x.dtype)
    return out if init is None else out ^ (init & 0xFFFF).to(x.dtype)


@pytest.mark.parametrize("use_static", [False, True])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_stream_map_matches_jax(use_static, prefetch):
    chunks = _chunks()
    init = np.arange(4, dtype=np.uint32) * 0x01010101
    if use_static:
        want = jstream.stream_map(jax.jit(lambda s, c: _jax_step(c, s)),
                                  chunks, prefetch=prefetch, static=init)
        got = stream.stream_map(lambda s, c: _torch_step(c, s), chunks,
                                device=CPU, prefetch=prefetch, static=init)
    else:
        want = jstream.stream_map(jax.jit(_jax_step), chunks,
                                  prefetch=prefetch)
        got = stream.stream_map(_torch_step, chunks, device=CPU,
                                prefetch=prefetch)
    want = [np.asarray(w) for w in want]
    got = [n(g) for g in got]
    assert len(got) == len(want) == len(chunks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
