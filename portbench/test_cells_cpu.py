"""Tests of the cell `wb1024soft-refsens`: its air against the arithmetic
its traffic file cites, the tiny cell correct against the plain
reference on the CPU and not correct when K4 loses the soft values'
magnitudes, the bound and the reader of `k4_roofline`, and (marked
`cuda`, skipped without a card) the cell and the TF32 control on the
card.

    python3 -m pytest portbench/test_cells_cpu.py -q -p no:cacheprovider
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
from unittest import mock

import pytest
import torch
from scipy.optimize import brentq
from scipy.special import i0e
from scipy.stats import ncx2

from portbench import check, registry, run
from portbench.test_portbench_cpu import E2E, ROOT, patched, tiny

CHANNEL_HZ = 25_000.0
SYMBOL_RATE = 18_000.0         # pi/4-DQPSK, 36 kbit/s
STATIC_REF_BER = 0.04          # EN 300 392-2 clause 6: TCH/7.2, MS static
FIRST_MHZ, LAST_MHZ = 380.0, 405.6          # the capture's span
DOWNLINK_MHZ = (390.0, 395.0)  # ERC/DEC/(96)01's emergency-services pair


def dqpsk_ber(ebn0_db: float) -> float:
    """Bit error ratio of Gray-coded pi/4-DQPSK with differential
    detection in AWGN: Q1(a, b) - I0(ab) exp(-(a^2 + b^2)/2) / 2."""
    g = 10 ** (ebn0_db / 10)
    a = math.sqrt(2 * g * (1 - 1 / math.sqrt(2)))
    b = math.sqrt(2 * g * (1 + 1 / math.sqrt(2)))
    return (ncx2.sf(b * b, 2, a * a)
            - 0.5 * i0e(a * b) * math.exp(-(a - b) ** 2 / 2))


def test_the_air_is_the_cited_arithmetic():
    ref = registry.load_traffic("refsens")
    assert "BER of 4%" in ref["source"] and "ERC/DEC/(96)01" in ref["source"]
    said = " ".join(ref["assumed"])
    # the formula's high-SNR end: about 2.3 dB behind coherent QPSK
    assert dqpsk_ber(10.0) == pytest.approx(3.43e-4, rel=0.01)
    ebn0 = brentq(lambda x: dqpsk_ber(x) - STATIC_REF_BER, 0.0, 10.0)
    assert round(ebn0, 2) == 4.45 and "Eb/N0 = 4.45 dB" in said
    esn0 = ebn0 + 10 * math.log10(2)
    assert round(esn0, 2) == 7.46 and "7.46 dB" in said
    snr = esn0 + 10 * math.log10(SYMBOL_RATE / CHANNEL_HZ)
    assert ref["snr_db"] == round(snr, 1) == 6.0
    # channel k of the capture is centred at FIRST_MHZ + 25 kHz x k
    cfg = registry.load_config(ROOT, registry.cell(
        registry.load_benchmark(ROOT), "wb1024soft-refsens")["config_entry"])
    n = int(cfg["n_chan"])
    assert FIRST_MHZ + n * CHANNEL_HZ / 1e6 == pytest.approx(LAST_MHZ)
    chans = [k for k in range(n)
             if DOWNLINK_MHZ[0] <= FIRST_MHZ + k * CHANNEL_HZ / 1e6
             < DOWNLINK_MHZ[1]]
    assert (chans[0], chans[-1], len(chans)) == (400, 599, 200)
    assert "channels 400-599" in said
    assert ref["on_air"] == len(chans) / n == 0.1953125
    assert round(ref["on_air"] * int(cfg["carriers"])) == 200


def test_the_soft_configuration_is_wb1024_soft_without_keys():
    wb = json.loads((ROOT / "portbench/configs/wb1024.json").read_text())
    soft = json.loads((ROOT / "portbench/configs/wb1024soft.json")
                      .read_text())
    assert soft["demod"] == "soft" and "keystore" not in soft
    same = set(wb) - {"demod", "keystore", "deployment", "source",
                      "assumed"}
    assert {k: soft[k] for k in same} == {k: wb[k] for k in same}
    entry = next(c for c in registry.load_benchmark(ROOT)["configs"]
                 if c["name"] == "wb1024soft")
    assert entry["reduced"] == []


CELL, CONFIG = "wb1024soft-refsens", "wb1024soft"
SEEDS = [2**31 + 2024, 3_987_654_321]


def run_tiny_cell(seed: int, trace: bool = False) -> dict:
    """The cell's configuration cut to 16 PFB channels at 400 kS/s under
    its own traffic, on the CPU; its result line as a dict."""
    full = registry.load_benchmark(ROOT)
    w = registry.cell(full, CELL)
    bench = {"workloads": [], "end_to_end": E2E,
             "per_layer": registry.cell_metrics(full, CELL, "per_layer")}
    out = io.StringIO()
    with contextlib.redirect_stderr(io.StringIO()), \
            mock.patch.object(run, "WARM_PASSES", 1):
        rc = run.run_cell(ROOT, bench, {"name": CELL, "chips": 1},
                          tiny(CONFIG), registry.load_traffic(w["traffic"]),
                          seed, 0.5, trace, "cpu", out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("seed", SEEDS)
def test_a_tiny_cell_is_correct(seed):
    r = run_tiny_cell(seed)
    assert r["correct"] is True and r["failed"] == 0
    c = r["compared"]
    assert c["slots"] > 0 and c["decisions"] > 0 and c["walk_tl_sdus"] > 0
    assert r["check"]["decisions_far"]["value"] == 0
    assert c["on_air"] == round(16 * 0.1953125) == 3
    # at this level some blocks fail their CRC, so K4's soft values count
    assert c["crc_wrong"] > 0 and c["crc_ok"] > c["crc_wrong"]


def _signs_only(fn):
    """K4 gets each soft value's sign at full scale: a hard-decision
    Viterbi in the soft one's place."""
    def w(*a, **k):
        soft, rm, ks_cell = fn(*a, **k)
        return torch.sign(soft) * 124.0, rm, ks_cell
    return w


@pytest.mark.parametrize("seed", SEEDS)
def test_k4_without_the_soft_magnitudes_is_not_correct(seed):
    with patched(("tetra_tpu_torch.lmac.fused", "assemble_soft"),
                 _signs_only):
        r = run_tiny_cell(seed)
    assert r["correct"] is False and r["failed"] == r["attempted"]
    assert r["check"]["slots_differing"]["value"] > 0
    assert r["check"]["decisions_far"]["value"] == 0


def test_a_traced_tiny_soft_cell_reports_its_span_metrics():
    r = run_tiny_cell(77_777, trace=True)
    assert r["correct"] is True
    # the device metrics, k4_roofline among them, need a card's trace
    assert set(r["metrics"]) == {"frontend_ms.pfb", "sync_ms", "fec_ms",
                                 "walk_ms", "host_rest_ms"}


def test_the_k4_bound_is_chip_smokes():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tetra_tpu_torch.lmac.fused import BOUNDARIES, N_SYM
    k4 = registry.load_reader("k4_roofline")
    rows, ns = 21_504, N_SYM
    # chip_smoke.check_k4's bound_n288, on x [rows, 4 x 288] f32 and the
    # restart mask [rows, 3] int8
    want = chip_smoke.bound(4 * rows * 4 * ns + rows * len(BOUNDARIES)
                            + rows * ns,
                            chip_smoke.viterbi_ops(rows, ns, 4),
                            chip_smoke.F32_OPS)
    got = k4.k4_bound(rows, ns, len(BOUNDARIES))
    assert got * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
    assert want["bound_by"] == "bytes"
    assert got * 1e3 == pytest.approx(0.0314, abs=5e-5)


ANON = "(anonymous namespace)::"
SIG = "(float const*, int, bool, int const*, signed char const*, int)"


@pytest.mark.parametrize("named", ["by_tag", "by_rows_before_the_tag"])
def test_the_k4_reader_divides_the_bound_by_k4s_kernel_time(named):
    """K4's time is that of the kernel tagged K4 (or, in a program from
    before the tag, of its 16-row instantiation), K6's left out; a
    profile whose K4 launches do not equal the calls raises."""
    k4 = registry.load_reader("k4_roofline")
    soft = torch.zeros(21_504, 1152)
    rm = torch.zeros(21_504, 3, dtype=torch.int8)
    need = k4.k4_bound(21_504, 288, 3)
    call = ((soft, rm, 288, (80, 144, 224)), {})
    if named == "by_tag":
        k4_name = f"void {ANON}viterbi_segmented_kernel<4, 4, {ANON}K4>{SIG}"
        k6_name = f"void {ANON}viterbi_segmented_kernel<2, 4, {ANON}K6>{SIG}"
    else:
        k4_name = f"void {ANON}viterbi_segmented_kernel<4, 4, 16>{SIG}"
        k6_name = f"void {ANON}viterbi_segmented_kernel<2, 4, 8>{SIG}"
    kernels = {k4_name: (4 * need, 2), k6_name: (9.0, 5),
               f"{ANON}viterbi_assembled_kernel(Args)": (7.0, 2)}
    ctx = mock.Mock(prof={"kernels": kernels, "annotated": {"k4": [1e-9] * 2},
                          "args": {"k4": [call, call]}})
    assert k4.read(ctx) == pytest.approx(50.0)
    ctx.prof = {"kernels": kernels, "args": {"k4": [call]}}
    with pytest.raises(RuntimeError, match="1 calls .* 2 launches"):
        k4.read(ctx)                     # 2 launches for 1 call
    ctx.prof = {"kernels": {k6_name: (9.0, 2)}, "args": {"k4": [call] * 2}}
    with pytest.raises(RuntimeError, match="0 launches"):
        k4.read(ctx)                     # K4 ran, and no launch is K4's
    ctx.prof = {"kernels": kernels, "args": {}}
    assert k4.read(ctx) is None          # K4 did not run
    ctx.prof = None
    assert k4.read(ctx) is None


# ----------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs the port's kernels")


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          CELL, "--seed", str(2**31 + 303), "--seconds",
                          "3", "--trace", "0"], capture_output=True,
                         text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["check"]["decisions_far"]["value"] == 0


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct(card):
    from portbench import control
    r = control.readings(CELL, 2**31 + 11, programs=0)["control"]
    assert r["fe_rel_err"] > check.LIMITS["fe_rel_err"]
    assert r["demod_rel_err"] > check.LIMITS["demod_rel_err"]
    assert r["demod_rel_err.demod_alone"] > check.LIMITS["demod_rel_err"]
