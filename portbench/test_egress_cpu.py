"""The benchmark's egress on the CPU: a tiny wb1024-shaped configuration
with `egress` (16 PFB channels at 400 kS/s, dumps and voice on), its
check against the plain reference, the faults that check has to see,
and the configurations without the key, which must run as before.

    python3 -m pytest portbench/test_egress_cpu.py -q -p no:cacheprovider
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import capture, check, egress, registry, run
from portbench import test_portbench_cpu as T
from portbench.reference import voice

torch.set_num_threads(4)

def tiny_egress() -> dict:
    return dict(T.tiny("wb1024"), egress=True)


def run_egress(seed: int, seconds: float = 1.0,
               unsampled: bool = False) -> dict:
    """The tiny egress cell once on the CPU; its result line. With
    `unsampled` the walk sample is empty, so that every carrier's traffic
    slots come from the egress check's own walk."""
    out = io.StringIO()
    bench = {"workloads": [], "end_to_end": T.E2E, "per_layer": []}
    sample = mock.patch.object(check, "walk_sample", lambda *a: np.zeros(
        0, np.int64)) if unsampled else contextlib.nullcontext()
    with contextlib.redirect_stderr(io.StringIO()), sample, \
            mock.patch.object(run, "WARM_PASSES", 1):
        rc = run.run_cell(T.ROOT, bench, {"name": "wb1024voice-mix",
                                          "chips": 1}, tiny_egress(),
                          registry.load_traffic("mix"), seed, seconds,
                          False, "cpu", out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def own_tmpdir(tmp_path, monkeypatch):
    """The process's TMPDIR for the test, empty."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


# -------------------------------------------------------- the reference

@pytest.mark.parametrize("width", [432, 216])
@pytest.mark.parametrize("keyed", [False, True])
def test_the_reference_egress_is_the_programs(width, keyed):
    from tetra_tpu_torch import rx
    g = np.random.default_rng(width + keyed)
    rows = g.integers(0, 2, (64, width)).astype(np.int8)
    ks = (g.integers(0, 2, (64, 274)) if keyed
          else np.zeros((64, 274))).astype(np.uint8)
    want = rx.voice_frames(torch.as_tensor(rows), ks)
    got = voice.cod_frames(torch.as_tensor(rows), ks)
    assert got.shape == (64, voice.COD_BYTES) and got.tobytes() == \
        want.tobytes()
    assert voice.dump_blocks(rows).tobytes() == rx.dump_blocks(rows).tobytes()


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.voice, portbench.egress\n"
            "from portbench import run\n"
            "print((run.forbidden_modules(), "
            "sorted({m.split('.')[0] for m in sys.modules})))\n"
            % str(T.ROOT))
    import subprocess
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=T.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    found, top = eval(out.stdout.strip().splitlines()[-1])
    assert found == [] and "tetra_tpu_torch" not in top


def test_the_key_is_validated():
    assert egress.enabled({}) is False
    assert egress.enabled({"egress": True}) is True
    assert "dumps_differing" in check.limits({"egress": True})
    assert "dumps_differing" not in check.limits({})
    for bad in (False, None, 1, {"dumps": True, "decode_voice": True}):
        with pytest.raises(ValueError):
            egress.enabled({"egress": bad})
        with pytest.raises(ValueError):
            check.limits({"egress": bad})


# ------------------------------------------------------------ the cell

@pytest.mark.parametrize("unsampled", [False, True],
                         ids=["walk_sample", "no_walk_sample"])
def test_an_egress_cell_is_correct_and_leaves_nothing(own_tmpdir,
                                                     unsampled):
    r = run_egress(2**31 + 2024, unsampled=unsampled)
    assert r["correct"] is True and r["failed"] == 0
    chk, c = r["check"], r["compared"]
    assert chk["dumps_differing"] == {"value": 0, "limit": 0}
    assert chk["voice_differing"] == {"value": 0, "limit": 0}
    assert list(chk)[-2:] == ["dumps_differing", "voice_differing"]
    assert c["dump_blocks"] > 0 and c["voice_frames"] == c["dump_blocks"]
    # clear and TEA1 frames, each compared byte for byte
    assert 0 < c["voice_frames_keyed"] < c["voice_frames"]
    assert c["bytes_written"] == c["dump_blocks"] * (
        voice.OUT_BYTES + len(voice.TXT_LINE) + voice.COD_BYTES)
    assert list(own_tmpdir.iterdir()) == []


def test_the_egress_is_written_inside_the_calls(own_tmpdir):
    from tetra_tpu_torch import rx_multi
    cfg = tiny_egress()
    cap = capture.make_capture(cfg, registry.load_traffic("mix"), 77, "cpu")
    cap["samples_host"] = cap["samples"].numpy()
    marks = []
    real_append = rx_multi.append_files

    def append(parts):
        marks.append(("append", time.perf_counter(), next(iter(parts))))
        return real_append(parts)

    real_make, real_remove = egress.make_dir, egress.remove_dir
    with run.keystore(cfg) as ks, \
            mock.patch.object(rx_multi, "append_files", append), \
            mock.patch.object(egress, "make_dir", lambda: marks.append(
                ("make", time.perf_counter())) or real_make()), \
            mock.patch.object(egress, "remove_dir", lambda d: marks.append(
                ("remove", time.perf_counter())) or real_remove(d)):
        p = run.Cell(cfg, cap, ks, "cpu").one_pass()
    calls = p["calls"]
    made, removed = marks[0], marks[-1]
    assert made[0] == "make" and made[1] < p["t0"]
    assert removed[0] == "remove" and removed[1] > p["t1"]
    appends = [m for m in marks if m[0] == "append"]
    assert appends and all(str(own_tmpdir) in m[2] for m in appends)
    assert all(any(s <= m[1] <= e for s, e, *_ in calls) for m in appends)
    assert p["egress"][:-1, 0].sum() > 0 and p["egress"][-1].sum() == 0
    assert list(own_tmpdir.iterdir()) == []


# ------------------------------------------------------------- faults

def _flip_a_voice_bit(fn):
    def w(rows, ks):
        out = fn(rows, ks).copy()
        out[0, 3] ^= 0x10
        return out
    return w


def _keystream_not_applied(fn):
    return lambda rows, ks: fn(rows, np.zeros_like(ks))


def _per_pass(change):
    """An append_files wrapper that alters each pass's first append
    (`change(parts)`), a pass known by its dump directory."""
    def make(fn):
        seen = set()

        def w(parts):
            root = os.path.dirname(os.path.dirname(next(iter(parts))))
            if root not in seen:
                seen.add(root)
                parts = change(parts, len(seen))
            return fn(parts)
        return w
    return make


def _drop_an_append(parts, _):
    path = next(p for p in parts if p.endswith(".out"))
    return {**parts, path: parts[path][1:]}


def _block_to_another_timeslot(parts, _):
    path = next(p for p in parts if p.endswith(".out"))
    stem, tn = path[:-len(".out")].rsplit("_", 1)
    other = f"{stem}_{(int(tn) + 1) % 4}.out"
    out = {**parts, path: parts[path][1:]}
    out[other] = parts[path][:1] + out.get(other, [])
    return out


def _extra_file_in_one_pass(parts, n):
    if n == 2:          # the first window pass (one warm pass before it)
        path = next(iter(parts))
        open(os.path.join(os.path.dirname(path), "stray.bin"), "wb").close()
    return parts


@pytest.mark.parametrize("target, make, number, unsampled", [
    ("voice_frames", _flip_a_voice_bit, "voice_differing", False),
    ("append_files", _per_pass(_drop_an_append), "dumps_differing", False),
    ("append_files", _per_pass(_block_to_another_timeslot),
     "dumps_differing", False),
    ("voice_frames", _keystream_not_applied, "voice_differing", False),
    ("voice_frames", _keystream_not_applied, "voice_differing", True),
    ("append_files", _per_pass(_extra_file_in_one_pass), "passes_differing",
     False),
], ids=["voice_bit_flipped", "append_dropped", "block_to_another_timeslot",
        "keystream_not_applied", "keystream_not_applied_outside_the_sample",
        "extra_file_in_one_pass"])
def test_a_broken_egress_is_not_correct(own_tmpdir, target, make, number,
                                        unsampled):
    with T.patched(("tetra_tpu_torch.rx_multi", target), make):
        r = run_egress(31337, unsampled=unsampled)
    assert r["correct"] is False
    assert r["check"][number]["value"] > 0
    assert list(own_tmpdir.iterdir()) == []


# ------------------------------------------ configurations without it

# what the parent's harness handed the receiver, and the keys of its
# result line
PARENT_KWARGS = {
    "pfb": {"fs", "pfb_channels", "n_chan", "keystore_path",
            "control_plane", "demod", "device"},
    "mixer": {"fs", "keystore_path", "control_plane", "demod", "device"}}
PARENT_RESULT = ["correct", "attempted", "failed", "metrics", "device",
                 "window", "compared", "check"]
PARENT_COMPARED = {"feeds", "slots", "carriers", "on_air", "decisions",
                   "decision_ties", "timing_ties", "timing_tie_gap",
                   "walk_carriers", "walk_tl_sdus", "passes", "crc_ok",
                   "crc_wrong", "tl_sdus"}
PARENT_CHECK = ["fe_rel_err", "demod_rel_err", "decisions_far",
                "feeds_differing", "slots_differing", "bursts_differing",
                "cells_differing", "walk_differing", "passes_differing"]


@pytest.mark.parametrize("name", ["wb1024", "rtl64"])
def test_without_the_key_the_run_is_the_parents(name, own_tmpdir,
                                                monkeypatch):
    from tetra_tpu_torch import rx_multi
    seen = []
    real = rx_multi.MultiCarrierReceiver

    class Recording(real):
        def __init__(self, *a, **k):
            seen.append(k)
            super().__init__(*a, **k)

    monkeypatch.setattr(rx_multi, "MultiCarrierReceiver", Recording)
    made = []
    monkeypatch.setattr(egress, "make_dir", lambda: made.append(1))
    r = T.run_tiny(name, 2**31 + 777)
    front = T.tiny(name)["front_end"]
    assert seen and all(set(k) == PARENT_KWARGS[front] for k in seen)
    assert made == [] and list(own_tmpdir.iterdir()) == []
    assert list(r) == PARENT_RESULT and r["correct"] is True
    assert set(r["compared"]) == PARENT_COMPARED
    assert list(r["check"]) == PARENT_CHECK
