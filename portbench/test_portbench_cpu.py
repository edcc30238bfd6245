"""The benchmark's own tests on the CPU (tiny cells, the program's plain
versions), and on the card (marked `cuda`, skipped without one).

    python3 -m pytest portbench/test_portbench_cpu.py -q -p no:cacheprovider

The tiny cells keep each configuration's shapes but cut the raster: 16
PFB channels at 400 kS/s, and 8 mixer carriers at 288 kS/s.
"""
from __future__ import annotations

import contextlib
import io
import json
import pathlib
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import capture, check, metrics, registry, run  # noqa: E402

torch.set_num_threads(4)


def tiny(name: str) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    if cfg["front_end"] == "pfb":
        cfg.update(carriers=16, n_chan=16, fs=400_000.0)
    else:
        cfg.update(carriers=8, fs=288_000.0, chunk_samples=144_000)
    cfg.update(check_walk_carriers=8)
    return cfg


E2E = registry.load_benchmark(ROOT)["end_to_end"]


def run_tiny(name: str, seed: int, seconds: float = 1.0,
             trace: bool = False) -> dict:
    """One tiny cell on the CPU; its result line as a dict. With trace,
    the per-layer metrics of the benchmark's cell on that config."""
    out = io.StringIO()
    full = registry.load_benchmark(ROOT)
    cell = next(w["name"] for w in full["workloads"] if w["config"] == name)
    bench = {"workloads": [], "end_to_end": E2E,
             "per_layer": registry.cell_metrics(full, cell, "per_layer")}
    with contextlib.redirect_stderr(io.StringIO()), \
            mock.patch.object(run, "WARM_PASSES", 1):
        rc = run.run_cell(ROOT, bench, {"name": cell, "chips": 1},
                          tiny(name), registry.load_traffic("mix"), seed,
                          seconds, trace, "cpu", out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


# ---------------------------------------------------------------- capture

def test_capture_is_deterministic_per_seed():
    cfg, mix = tiny("wb1024"), registry.load_traffic("mix")
    a = capture.make_capture(cfg, mix, 2**31 + 12345, "cpu")
    b = capture.make_capture(cfg, mix, 2**31 + 12345, "cpu")
    c = capture.make_capture(cfg, mix, 7, "cpu")
    assert torch.equal(a["samples"], b["samples"])
    assert torch.equal(a["rolls"], b["rolls"])
    assert not torch.equal(a["samples"], c["samples"])
    assert int(a["encrypted"].sum()) == int(c["encrypted"].sum()) == 2


def test_capture_matches_the_program_fixture_at_its_rolls():
    from tetra_tpu_torch import prod_fixture as P
    fx = P.load()
    bits, n_enc = P.mixed_bits(16, 0.1, fx)
    want = P.wideband_capture(bits)
    base = capture.modulate(torch.as_tensor(bits))
    T_in = base.shape[1]
    wide = capture.synthesize_bins(base, capture.grid_bins(range(16), 16,
                                                           T_in),
                                   int(round(T_in / 36_000 * 400_000)))
    assert np.array_equal(capture.quantize_iq4c(wide).numpy(), want)
    mbits = P.mixed_bits(64, 0.1, fx)[0]
    fxm = P.load_mixer()
    want = P.mixer_capture(mbits, fxm["mixer_bins"])
    base = capture.modulate(torch.as_tensor(mbits))
    bins = capture.offgrid_bins(64, 1370.0, base.shape[1])
    assert np.array_equal(bins, fxm["mixer_bins"])
    T_out = int(round(base.shape[1] / 36_000 * 1_800_000))
    wide = capture.synthesize_bins(base, bins, T_out)
    rng = np.random.default_rng(9)
    nz = 3e-3 * (rng.standard_normal(T_out) + 1j * rng.standard_normal(T_out))
    got = capture.u8_iq(wide, torch.as_tensor(nz.astype(np.complex64)))
    # the program's chain filters and transforms in single precision, this
    # one in double: a few of the 3.7 M bytes round the other way
    d = got.numpy().astype(int) - want
    assert np.count_nonzero(d) <= 1e-5 * d.size and np.abs(d).max() <= 1


def test_rolls_stay_in_the_screened_window():
    rows = capture.load_rows("prod_mixed")
    L = len(rows["plain"])
    g = capture.seed_generator(99, "cpu")
    rolls, enc = capture.draw_layout(1024, L, rows["n_tail"], 0.1, g, "cpu")
    start = (L - rolls.numpy()) % L       # where each carrier's stream starts
    lo = L - rows["n_tail"] + capture.GUARD
    W = rows["n_tail"] + capture.HEAD_NOISE - 2 * capture.GUARD
    assert (((start - lo) % L) < W).all()
    assert int(enc.sum()) == 102


# ---------------------------------------------------------------- metrics

def test_carriers_rt_and_the_p95():
    assert metrics.carriers_rt(1024, 1.0, 30, 15.0) == pytest.approx(2048.0)
    assert metrics.p95(list(range(101))) == pytest.approx(95.0)
    assert metrics.p95([1.0, 2.0]) == pytest.approx(1.95)


def test_chunk_latency_under_pipeline_depth_two():
    # 4 calls of 1 s each; at depth 2 chunk 0 is out after call 2, the
    # final call drains chunks 1-3
    calls = [(0.0, 1.0, 0, True), (1.0, 2.0, 0, True), (2.0, 3.0, 1, True),
             (3.0, 4.0, 4, True)]
    assert metrics.chunk_latencies(calls) == [3.0, 3.0, 2.0, 1.0]
    # the live source's final empty call submits no chunk of its own
    calls = [(0.0, 1.0, 0, True), (1.0, 2.0, 0, True), (2.0, 3.0, 1, True),
             (3.0, 3.5, 4, False)]
    assert metrics.chunk_latencies(calls) == [3.0, 2.5, 1.5]


# -------------------------------------------------------------- discovery

def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "layers").mkdir()
    (tmp_path / "configs" / "newcfg.json").write_text('{"carriers": 3}')
    (tmp_path / "traffic" / "newmix.json").write_text('{"enc_frac": 0.5}')
    (tmp_path / "layers" / "new_metric.x.py").write_text(
        "SPANS = {}\ndef read(ctx):\n    return 41.5\n")
    bench = {"configs": [{"name": "newcfg",
                          "file": "configs/newcfg.json"}],
             "workloads": [{"name": "newcell", "config": "newcfg",
                            "traffic": "newmix", "chips": 1}],
             "end_to_end": [{"name": "setup_s"}],
             "per_layer": [{"name": "new_metric.x",
                            "workloads": ["newcell"]},
                           {"name": "elsewhere", "workloads": ["other"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = registry.load_benchmark(tmp_path)
    w = registry.cell(b, "newcell")
    assert registry.load_config(tmp_path, w["config_entry"]) == {"carriers": 3}
    assert registry.load_traffic("newmix", tmp_path) == {"enc_frac": 0.5}
    pl = registry.cell_metrics(b, "newcell", "per_layer")
    assert [m["name"] for m in pl] == ["new_metric.x"]
    assert registry.load_reader("new_metric.x", tmp_path).read(None) == 41.5


def test_every_cell_of_the_benchmark_resolves():
    b = registry.load_benchmark(ROOT)
    for w in b["workloads"]:
        c = registry.cell(b, w["name"])
        registry.load_config(ROOT, c["config_entry"])
        registry.load_traffic(w["traffic"])
        for m in registry.cell_metrics(b, w["name"], "per_layer"):
            assert callable(registry.load_reader(m["name"]).read)


# ------------------------------------------------------------ no jax here

def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tetra_tpu_torch_fake", object())
    assert "tetra_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tetra_tpu.x", object())
    assert "tetra_tpu.x" in run.forbidden_modules()


def test_a_run_loads_no_jax_and_reads_nothing_of_benchmarks():
    code = ("import sys, io, contextlib; sys.path.insert(0, %r)\n"
            "from portbench import test_portbench_cpu as t, run\n"
            "t.run_tiny('wb1024', 5, 0.2)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-2000:]
    top = eval(out.stdout.strip().splitlines()[-1])
    assert not {"jax", "jaxlib", "flax", "tetra_tpu", "benchmarks"} & set(top)
    assert "tetra_tpu_torch" in top
    for p in (ROOT / "portbench").rglob("*.py"):
        if p.name.startswith("test_"):
            continue
        text = p.read_text()
        assert "benchmarks/" not in text.replace("portbench", "")
        assert "import benchmarks" not in text and "from benchmarks" not in text


# ------------------------------------------------------------- the result

def test_the_last_line_has_the_contract_keys_and_is_correct():
    for name in ("wb1024", "rtl64"):
        r = run_tiny(name, 2**31 + 777)
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
        assert list(r)[-1] == "check"
        assert r["correct"] is True and r["failed"] == 0
        assert set(r["metrics"]) == {"chunk_p95_ms", "setup_s"}
        assert r["window"]["carriers_rt"] > 0
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
            set(r["device"])
        assert r["compared"]["slots"] > 0 and r["compared"]["walk_tl_sdus"] > 0


def test_a_traced_run_reports_the_span_metrics():
    for name, fe in (("wb1024", "frontend_ms.pfb"),
                     ("rtl64", "frontend_ms.mixer")):
        r = run_tiny(name, 424242, 0.5, trace=True)
        assert r["correct"] is True
        got = set(r["metrics"])
        # the device metrics need a card's trace: a CPU run has none
        assert {fe, "sync_ms", "fec_ms", "walk_ms", "host_rest_ms"} == got
        assert all(v["value"] > 0 for v in r["metrics"].values())


# ----------------------------------------------------------------- faults

@contextlib.contextmanager
def patched(target, make):
    from portbench.spans import Patches
    p = Patches()
    p.wrap(target, make)
    try:
        yield
    finally:
        p.restore()


def _scaled_front_end(fn):
    def w(*a, **k):
        cr, ci = fn(*a, **k)
        return cr * (1 + 1e-3), ci
    return w


def _scaled_phasors(fn):
    def w(*a, **k):
        sr, si = fn(*a, **k)
        return sr * (1 + 1e-3), si
    return w


def _flipped_decode(fn):
    def w(*a, **k):
        res = fn(*a, **k)
        t1 = res["schf"].type1.clone()
        t1[:, 100] ^= 1
        res["schf"] = res["schf"]._replace(type1=t1)
        return res
    return w


def _half_the_carriers(fn):
    def w(*a, **k):
        bits = fn(*a, **k)
        bits = bits.clone()
        bits[bits.shape[0] // 2:] = 0
        return bits
    return w


def _state_unchanged(fn):
    def w(ring, chunk, *a, **k):
        bundle, _, carry, t4f, t4b = fn(ring, chunk, *a, **k)
        st0, bs0, nb0, nfs0, scr0 = a[2], a[3], a[4], a[5], a[7]
        return bundle, ring, (st0, bs0 - a[1], nb0, nfs0 - a[1], scr0), \
            t4f, t4b
    return w


@pytest.mark.parametrize("target, make", [
    (("tetra_tpu_torch.phy.pfb", "pfb_to_demod_rate_ri"), _scaled_front_end),
    (("tetra_tpu_torch.phy.dqpsk", "_stream_phasors"), _scaled_phasors),
    (("tetra_tpu_torch.lmac.fused", "decode_slots_fused"), _flipped_decode),
    (("tetra_tpu_torch.fastpath", "_iq_frontend"), _half_the_carriers),
    (("tetra_tpu_torch.fastpath", "_fused_chunk_body"), _state_unchanged),
], ids=["token_altered_in_the_front_end", "token_altered_in_the_demod",
        "answer_altered_in_the_fec",
        "half_the_batch_left_out", "state_returned_unchanged"])
def test_a_broken_timed_path_is_not_correct(target, make):
    with patched(target, make):
        r = run_tiny("wb1024", 31337)
    assert r["correct"] is False
    assert r["failed"] == r["attempted"]


# ----------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs the port's kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["wb1024-mix", "rtl64-mix"])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          workload, "--seed", str(2**31 + 99), "--seconds",
                          "3", "--trace", "0"], capture_output=True,
                         text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["wb1024-mix", "rtl64-mix"])
def test_the_tf32_control_is_not_correct(card, workload):
    from portbench import control
    for seed in (11, 2**31 + 5, 4_000_000_007):
        r = control.readings(workload, seed, programs=0)["control"]
        assert r["fe_rel_err"] > check.LIMITS["fe_rel_err"]
        assert r["demod_rel_err"] > check.LIMITS["demod_rel_err"]
        assert r["demod_rel_err.demod_alone"] > check.LIMITS["demod_rel_err"]
