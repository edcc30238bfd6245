"""The port's tracing (utils.trace) over a tiny native-plane receiver
pass on the CPU: off, it records and costs nothing; on, every chunk has
one span of each of its stages under one id, self times add up, the
collector and the overflow re-run are counted, and every span is a
"tt:" range under torch.profiler, nested as the program nested it. The
soft receiver adds the span "chunk.fec.k4" and the counter
"fec.soft_rows"; "slots.crc_wrong" counts the blocks the walk found
failing their CRC, as the JAX package's receiver counts them. The
rtl-sdr ingest's u8 conversion is a span "io.u8" of its own. The bundle
parse counts each chunk's rows as "parse.rows_native" where the host
library ran it, "parse.rows_numpy" where the numpy fallback did."""
import gc
from collections import Counter

import numpy as np
import pytest

from tests._torch_util import CPU
from tetra_tpu_torch import fastpath, hostlib, prod_fixture
from tetra_tpu_torch.io.sdr import RtlTcpSource
from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
from tetra_tpu_torch.umac import native_exec
from tetra_tpu_torch.utils import trace

CHUNK_SPANS = ("chunk.submit", "chunk.fetch_wait", "chunk.parse",
               "chunk.walk", "chunk.egress")


@pytest.fixture(scope="module")
def capture():
    if not native_exec.available():
        pytest.skip("native library unavailable")
    bits, _ = prod_fixture.mixed_bits(8, 0.25)
    return prod_fixture.wideband_capture(bits[:, :16_000])


@pytest.fixture
def traced():
    """Tracing on for the test, off and cleared after it."""
    trace.reset()
    trace.set_level(1)
    try:
        yield
    finally:
        trace.set_level(0)
        trace.reset()


@pytest.fixture(scope="module")
def noisy_capture():
    """The 8-carrier slice at 8 dB per-channel SNR: the soft receiver's
    air, where some blocks fail their CRC."""
    if not native_exec.available():
        pytest.skip("native library unavailable")
    bits, _ = prod_fixture.mixed_bits(8, 0.25)
    return prod_fixture.wideband_capture(bits[:, :16_000], snr_db=8.0)


def one_pass(packed, calls: int = 4,
             demod: str = "hard") -> MultiCarrierReceiver:
    """The 8-carrier slice through a fresh native-plane receiver in
    `calls` process_iq4c calls, final on the last."""
    rx = MultiCarrierReceiver([], fs=2e5, pfb_channels=np.arange(8),
                              n_chan=8, control_plane="native",
                              demod=demod, device=CPU)
    cuts = np.linspace(0, len(packed), calls + 1).astype(int)
    for k in range(calls):
        rx.process_iq4c(packed[cuts[k]:cuts[k + 1]], final=k == calls - 1)
    return rx


def results(rx) -> tuple:
    stats = [(c.stats.bursts, c.stats.slots, c.stats.crc_ok,
              c.stats.crc_wrong, c.scramb_init) for c in rx.carriers]
    events = {k: np.concatenate([e[k] for e in rx.native_events]).tolist()
              for k in ("carrier", "kind", "a", "b", "c", "d")}
    return stats, events


def test_off_records_and_costs_nothing(capture, monkeypatch):
    """Off: no span, counter or chunk record, no collector hook, no
    clock read and no profiler range; every span is one shared object."""
    trace.set_level(0)
    trace.reset()
    used = Counter()
    clock, rf = trace._clock, trace._record_function
    monkeypatch.setattr(trace, "_clock",
                        lambda: (used.update(["clock"]), clock())[1])
    monkeypatch.setattr(trace, "_record_function",
                        lambda name: (used.update(["range"]), rf(name))[1])
    hooks = list(gc.callbacks)
    rx = one_pass(capture)
    gc.collect()
    assert rx.native_events
    assert trace.spans() == {} and trace.counters() == {}
    assert trace.chunk_records() == {}
    assert not used
    assert gc.callbacks == hooks and trace._on_gc not in gc.callbacks
    assert trace.span("a") is trace.span("b", 7)


def test_each_chunk_has_one_span_of_each_stage(capture, traced):
    """Ids are contiguous; each chunk has exactly one submit, fetch
    wait, parse, walk and egress span, and its front end, sync and FEC
    inside its submit; its submit ends before its collect starts."""
    rx = one_pass(capture)
    recs = trace.chunk_records()
    ids = sorted(recs)
    assert len(ids) == len(rx.native_events) >= 3
    assert ids == list(range(ids[0], ids[0] + len(ids)))
    for c in ids:
        names = Counter(n for n, _, _ in recs[c])
        for n in CHUNK_SPANS + ("chunk.frontend", "chunk.sync",
                                "chunk.fec"):
            assert names[n] == 1, (c, n, names)
        at = {n: (s, e) for n, s, e in recs[c]}
        assert at["chunk.submit"][1] < at["chunk.fetch_wait"][0]
        for n in ("chunk.frontend", "chunk.sync", "chunk.fec"):
            assert at["chunk.submit"][0] <= at[n][0] <= at[n][1] \
                <= at["chunk.submit"][1]
        assert (at["chunk.fetch_wait"][1] <= at["chunk.parse"][0]
                <= at["chunk.walk"][0] <= at["chunk.egress"][0])


def test_self_times_add_up(capture, traced):
    """A call's total is its self time plus its children's totals; the
    spans' parents are those the program nests them in."""
    one_pass(capture)
    sp = trace.spans()
    assert sp["call"]["count"] == 4 and sp["rx.build"]["count"] == 1
    assert set(sp["rx.build"]["parents"]) <= {None}
    assert set(sp["call"]["parents"]) == {None}
    kids = sum(s["parents"].get("call", 0.0) for s in sp.values())
    assert sp["call"]["total_s"] == pytest.approx(
        sp["call"]["self_s"] + kids, rel=1e-9, abs=1e-9)
    assert 0 < sp["call"]["self_s"] < sp["call"]["total_s"]
    for n in CHUNK_SPANS:
        assert set(sp[n]["parents"]) - {"gc"} == {"call"}, n
    for n in ("chunk.frontend", "chunk.sync", "chunk.fec"):
        assert set(sp[n]["parents"]) - {"gc"} == {"chunk.submit"}, n
    assert trace.timings()["call"]["n"] == 4


def test_collector_is_a_span_of_its_own(traced):
    """A collection inside a span is a "gc" child of it; turning tracing
    off removes the hook."""
    assert trace._on_gc in gc.callbacks
    with trace.span("outer"):
        gc.collect()
    sp = trace.spans()
    assert sp["gc"]["parents"].get("outer", 0.0) > 0
    assert sp["outer"]["self_s"] <= sp["outer"]["total_s"] \
        - sp["gc"]["parents"]["outer"] + 1e-9
    trace.set_level(0)
    assert trace._on_gc not in gc.callbacks


def test_overflow_rerun_is_counted(capture, traced, monkeypatch):
    """A row budget forced below the emit rate re-runs chunks: each
    re-run is counted once and spanned, and the pass decodes what the
    unforced pass decodes."""
    want = results(one_pass(capture))
    assert not trace.counters().get("chunk.reruns")
    trace.reset()
    calls = []
    rerun = fastpath.FastChunkPipeline._overflow_rerun
    monkeypatch.setattr(fastpath, "G_SLACK", -6)
    monkeypatch.setattr(fastpath.FastChunkPipeline, "_overflow_rerun",
                        lambda self, h: (calls.append(h), rerun(self, h))[1])
    got = results(one_pass(capture))
    assert calls
    assert trace.counters()["chunk.reruns"] == len(calls)
    assert trace.spans()["chunk.rerun"]["count"] == len(calls)
    assert got == want


def test_parse_rows_are_counted_under_the_parse_that_ran(capture, traced,
                                                        monkeypatch):
    """With the host library, parse.rows_native sums the rows of every
    collected chunk and parse.rows_numpy is absent; with the library
    taken away the numpy fallback counts them as parse.rows_numpy, and
    the pass decodes the same."""
    if hostlib.lib() is None:
        pytest.skip("host library cannot be built or loaded")
    # each collected chunk's dict once: after an overflow re-run the
    # nested collect and the outer one return the same dict
    dicts = []
    collect = fastpath.FastChunkPipeline.collect

    def counted(self, h):
        d = collect(self, h)
        if not any(d is x for x in dicts):
            dicts.append(d)
        return d

    monkeypatch.setattr(fastpath.FastChunkPipeline, "collect", counted)
    rx = one_pass(capture)
    want = results(rx)
    c = trace.counters()
    assert len(dicts) == len(rx.native_events) >= 3
    assert c["parse.rows_native"] == sum(len(d["carrier"]) for d in dicts) > 0
    assert "parse.rows_numpy" not in c
    trace.reset()
    dicts.clear()
    monkeypatch.setattr(hostlib, "lib", lambda: None)
    rx = one_pass(capture)
    c = trace.counters()
    assert c["parse.rows_numpy"] == sum(len(d["carrier"]) for d in dicts) > 0
    assert "parse.rows_native" not in c
    assert results(rx) == want


def test_spans_are_profiler_ranges(capture, traced):
    """Under torch.profiler every span is a "tt:<name>" range, and the
    profiler nests each under the range of the span the program nested
    it in."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        one_pass(capture, calls=2)
    sp = trace.spans()
    evs = [e for e in prof.events() if e.name.startswith("tt:")]
    assert {e.name[3:] for e in evs} == set(sp)
    for e in evs:
        p = e.cpu_parent
        while p is not None and not p.name.startswith("tt:"):
            p = p.cpu_parent
        parent = p.name[3:] if p is not None else None
        assert parent in sp[e.name[3:]]["parents"], (e.name, parent)


def test_soft_rows_are_the_rows_handed_to_k4(noisy_capture, traced,
                                             monkeypatch):
    """fec.soft_rows counts the rows that reach K4 (its plain version on
    the CPU), and only the soft receiver counts it."""
    from tetra_tpu_torch.ops import viterbi_segmented
    rows = []
    plain = viterbi_segmented.decode_segmented
    monkeypatch.setattr(viterbi_segmented, "decode_segmented",
                        lambda soft, *a: (rows.append(soft.shape[0]),
                                          plain(soft, *a))[1])
    one_pass(noisy_capture, demod="soft")
    assert len(rows) >= 3
    assert trace.counters()["fec.soft_rows"] == sum(rows)
    trace.reset()
    n = len(rows)
    one_pass(noisy_capture)
    assert "fec.soft_rows" not in trace.counters() and len(rows) == n


@pytest.mark.parametrize("demod", ["hard", "soft"])
def test_crc_wrong_reads_0_on_a_clean_capture(capture, traced, demod):
    """The clean mix's traffic slots fail the SCH/F CRC they do not
    carry; the walk takes them as traffic, and slots.crc_wrong reads 0."""
    rx = one_pass(capture, demod=demod)
    kinds = np.concatenate([e["kind"] for e in rx.native_events])
    assert (kinds == native_exec.EV.TRAFFIC).sum() > 0
    assert trace.counters()["slots.crc_wrong"] == 0
    assert sum(c.stats.crc_ok for c in rx.carriers) > 0


@pytest.mark.parametrize("demod", ["hard", "soft"])
def test_crc_wrong_counts_the_blocks_that_failed(noisy_capture, traced,
                                                 demod):
    """On the 8 dB slice slots.crc_wrong equals the CRC failures that the
    JAX package's receiver counts on the same calls."""
    from tetra_tpu.rx_multi import MultiCarrierReceiver as JaxReceiver
    ref = JaxReceiver([], fs=2e5, pfb_channels=np.arange(8), n_chan=8,
                      control_plane="native", demod=demod)
    cuts = np.linspace(0, len(noisy_capture), 5).astype(int)
    for k in range(4):
        ref.process_iq4c(noisy_capture[cuts[k]:cuts[k + 1]], final=k == 3)
    want = sum(c.stats.crc_wrong for c in ref.carriers)
    assert want > 0
    rx = one_pass(noisy_capture, demod=demod)
    assert trace.counters()["slots.crc_wrong"] == want
    assert sum(c.stats.crc_wrong for c in rx.carriers) == want


def test_k4_span_nests_under_the_fec_span(noisy_capture, traced):
    """chunk.fec.k4 is a child of chunk.fec, once in each chunk's
    record, inside that chunk's chunk.fec."""
    rx = one_pass(noisy_capture, demod="soft")
    sp = trace.spans()
    assert set(sp["chunk.fec.k4"]["parents"]) - {"gc"} == {"chunk.fec"}
    recs = trace.chunk_records()
    assert len(recs) == len(rx.native_events) >= 3
    for c, rec in recs.items():
        at = {n: (s, e) for n, s, e in rec}
        assert Counter(n for n, _, _ in rec)["chunk.fec.k4"] == 1, c
        assert at["chunk.fec"][0] <= at["chunk.fec.k4"][0] \
            <= at["chunk.fec.k4"][1] <= at["chunk.fec"][1]


def test_soft_counters_off_move_nothing(noisy_capture):
    """Off, the soft receiver counts nothing, and it decodes what it
    decodes with tracing on."""
    trace.set_level(0)
    trace.reset()
    off = results(one_pass(noisy_capture, demod="soft"))
    assert trace.counters() == {} and trace.spans() == {}
    trace.set_level(1)
    try:
        on = results(one_pass(noisy_capture, demod="soft"))
        assert trace.counters()["fec.soft_rows"] > 0
    finally:
        trace.set_level(0)
        trace.reset()
    assert on == off
    assert sum(s[3] for s in off[0]) > 0    # some blocks failed their CRC


def test_u8_conversion_is_a_span_without_a_parent(traced):
    """On, each _to_complex call records one io.u8 span with no parent;
    off, it records nothing and returns the same samples."""
    raw = np.random.default_rng(5).integers(0, 256, 2 * 4096,
                                            dtype=np.uint8)
    on = [RtlTcpSource._to_complex(raw) for _ in range(3)]
    sp = trace.spans()["io.u8"]
    assert sp["count"] == 3 and set(sp["parents"]) == {None}
    trace.set_level(0)
    trace.reset()
    off = RtlTcpSource._to_complex(raw)
    assert trace.spans() == {} and trace.counters() == {}
    assert trace.chunk_records() == {}
    for a in on:
        assert np.array_equal(a.view(np.uint32), off.view(np.uint32))
