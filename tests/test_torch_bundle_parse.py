"""The bundle parse (`FastChunkPipeline._decode_segments`): the host
library's one C++ pass (`hostsrc/bundle.cpp`) gives the collect dict of
the numpy fallback key for key and bit for bit on synthetic bundles, and
two processes that build the library at once both load it."""
import pathlib
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from tetra_tpu_torch import fastpath, hostlib
from tetra_tpu_torch.fastpath import ROW_BYTES, SIDE_I32

REPO = pathlib.Path(__file__).resolve().parent.parent

# case -> (shards, row budget a shard, carriers a shard, the kinds drawn,
# valid rows of each parsed shard, shard ids parsed, what to expect)
CASES = {
    "sync": (1, 256, 64, [0], [200], None, "dict"),
    "schf": (1, 256, 64, [1], [200], None, "dict"),
    "ndb": (1, 256, 64, [2], [200], None, "dict"),
    "mixed": (1, 256, 64, [0, 1, 2, 3], [231], None, "dict"),
    "full_budget": (1, 128, 64, [0, 1, 2], [128], None, "dict"),
    "two_shards": (2, 128, 32, [0, 1, 2], [97, 128], None, "dict"),
    "four_shards": (4, 96, 16, [0, 1, 2], [60, 0, 96, 33], None, "dict"),
    "one_shard_of_four": (4, 96, 16, [0, 1, 2], [71], [2], "dict"),
    "no_rows": (2, 64, 32, [0, 1, 2], [0, 0], None, "dict"),
    "overflow": (2, 64, 32, [0, 1, 2], [40, 65], None, "overflow"),
    "hole": (1, 128, 64, [0, 1, 2], [100], None, "hole"),
}


def bundle(case: str, seed: int = 5):
    """(pipeline stand-in, G, segs [k, L] int8, ids) for one case. Row
    i of a shard carries okA/okB pair i % 4, delta 0, 255 or random,
    a 16-bit carrier id (most above 255) and random flag bits 5-7; the
    rows past the valid prefix are random bytes with the valid bit
    clear."""
    ns, gl, bl, kinds, tots, ids, expect = CASES[case]
    ids = np.arange(ns) if ids is None else np.asarray(ids, np.int32)
    rng = np.random.default_rng(seed)
    segs = []
    for tot in tots:
        rows = rng.integers(0, 256, (gl, ROW_BYTES), dtype=np.uint8)
        i = np.arange(gl)
        flags = (rng.choice(kinds, gl) | ((i % 4) << 2)
                 | (rng.integers(0, 8, gl) << 5))
        flags[:min(tot, gl)] |= 16
        rows[:, 36] = flags
        rows[:, 37] = np.where(i % 3 == 0, 0,
                               np.where(i % 3 == 1, 255, rows[:, 37]))
        if expect == "hole":
            rows[tot // 2, 36] &= 0xEF
        side = rng.integers(-2**31, 2**31, (bl, SIDE_I32), dtype=np.int64) \
            .astype(np.int32)
        side[:, 0] = np.bincount(rng.integers(0, bl, tot), minlength=bl)
        segs.append(np.concatenate([rows.reshape(-1).view(np.int8),
                                    side.reshape(-1).view(np.int8)]))
    stub = types.SimpleNamespace(shards=ns, n=bl * ns)
    return stub, gl * ns, np.stack(segs), ids


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_parse_equals_numpy(case, monkeypatch):
    if hostlib.lib() is None:
        pytest.skip("host library cannot be built or loaded")
    stub, G, segs, ids = bundle(case)
    expect = CASES[case][-1]
    keep = segs.copy()

    def parse():
        return fastpath.FastChunkPipeline._decode_segments(stub, G, segs,
                                                           ids)

    if expect == "hole":
        with pytest.raises(RuntimeError, match="must form a prefix"):
            parse()
        monkeypatch.setattr(hostlib, "lib", lambda: None)
        with pytest.raises(RuntimeError, match="must form a prefix"):
            parse()
        return
    got = parse()
    monkeypatch.setattr(hostlib, "lib", lambda: None)
    want = parse()
    assert np.array_equal(segs, keep)
    if expect == "overflow":
        assert got is None and want is None
        return
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    assert len(got["carrier"]) == sum(CASES[case][4])
    assert (got["payload"][:, 406:] == 0).all()
    if len(got["carrier"]):
        assert got["carrier"].max() > 255
        assert {0, 255} <= set(got["delta"].tolist())
        assert {(a, b) for a, b in zip(got["okA"], got["okB"])} \
            == {(0, 0), (1, 0), (0, 1), (1, 1)}


def test_build_without_gxx_raises(tmp_path, monkeypatch):
    """No g++ and no library built: build() raises FileNotFoundError,
    which lib() turns into None (the numpy parse)."""
    monkeypatch.setattr(hostlib, "_BUILD", tmp_path / "host")
    monkeypatch.setattr(hostlib.shutil, "which", lambda name: None)
    with pytest.raises(FileNotFoundError):
        hostlib.build()
    assert not (tmp_path / "host").exists()


LOADER = """
import pathlib, sys, time
from tetra_tpu_torch import hostlib
tmp = pathlib.Path(sys.argv[1])
hostlib._BUILD = tmp / "host"
(tmp / ("ready" + sys.argv[2])).touch()
while not (tmp / "go").exists():
    time.sleep(0.001)
lib = hostlib.lib()
print(lib._name if lib is not None else "NONE")
"""


def test_two_processes_build_and_load_at_once(tmp_path):
    """Two processes released together on an empty build directory both
    build, link to their own temporary names, rename, and load; the
    directory is left with the one library. Time limit: 120 s."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    deadline = time.monotonic() + 120
    procs = [subprocess.Popen([sys.executable, "-c", LOADER, str(tmp_path),
                               str(i)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    try:
        while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
            assert time.monotonic() < deadline, "loaders did not start"
            assert all(p.poll() is None for p in procs), \
                "a loader exited before the start"
            time.sleep(0.01)
        (tmp_path / "go").touch()
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    built = sorted((tmp_path / "host").iterdir())
    assert len(built) == 1 and built[0].suffix == ".so"
    assert paths == {str(built[0])}
