"""portbench.program_trace on the CPU at a tiny cell (the program's plain
versions): the program window's host metrics and span coverage, no
device metric without a card, tracing left off, and nothing read from a
program without spans.

    python3 -m pytest portbench/test_program_trace_cpu.py -q \\
        -p no:cacheprovider
"""
from __future__ import annotations

import pathlib
import sys
from unittest import mock

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import program_trace, registry, run  # noqa: E402
from portbench.test_portbench_cpu import tiny  # noqa: E402


def test_a_tiny_cell_splits_its_passes():
    from tetra_tpu_torch.umac import native_exec
    from tetra_tpu_torch.utils import trace
    if not native_exec.available():
        pytest.skip("native library unavailable")
    with mock.patch.object(run, "WARM_PASSES", 1):
        res = program_trace.trace_cell(tiny("wb1024"),
                                       registry.load_traffic("mix"),
                                       2**31 + 12345, 0.5, "cpu")
    m = res["program"]["metrics"]
    assert set(m) == set(program_trace.SPAN_METRICS) | {
        "call_self_ms", "rerun_share", "chunk_queue_ms", "coverage"}
    assert 0.98 <= m["coverage"] <= 1.0 + 1e-9
    assert m["rerun_share"] == 0 and m["chunk_queue_ms"] > 0
    assert all(m[k] > 0 for k in ("rx_build_ms", "dispatch_ms", "parse_ms",
                                  "native_walk_ms", "egress_ms"))
    assert res["wrapped"]["walk_ms"] > 0
    prof = res["profiled"]
    assert prof["frontend_dev_ms.pfb"] is None and prof["busy_s"] == 0
    assert prof["device_idle_share"] is None
    assert not trace.enabled(1) and trace.spans() == {}


def test_a_program_without_spans_reads_nothing():
    empty = {"spans": {}, "counters": {}, "chunk_records": {}, "chunks": 4,
             "pass_s": [1.0]}
    assert program_trace.host_metrics(empty) == {}
