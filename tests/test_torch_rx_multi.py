"""The PyTorch port's production receiver end to end vs tetra_tpu's
MultiCarrierReceiver on the CPU (TestProdConfig capture: 8 carriers,
fs = 200 kHz, PFB, native control plane, TEA1-encrypted carriers), the
pre-demodulated bits entry, the imports (nothing of jax or tetra_tpu),
and the options that are not ported."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tests._torch_util import CPU
from tests.test_sync_vec import make_stream

from tetra_tpu.rx_multi import MultiCarrierReceiver as JaxReceiver
from tetra_tpu.umac import native_exec

from tetra_tpu_torch.rx_multi import MultiCarrierReceiver

ROOT = pathlib.Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.skipif(not native_exec.available(),
                                reason="native library unavailable")


def _same_receivers(ref, got, n_car):
    for c in range(n_car):
        p, q = ref.carriers[c], got.carriers[c]
        assert (p.stats.bursts, p.stats.slots, p.stats.crc_ok,
                p.stats.crc_wrong) == (q.stats.bursts, q.stats.slots,
                                       q.stats.crc_ok, q.stats.crc_wrong), c
        assert (p.time.tn, p.time.fn, p.time.mn) == \
            (q.time.tn, q.time.fn, q.time.mn), c
        assert (p.colour_code, p.mcc, p.mnc, p.scramb_init) == \
            (q.colour_code, q.mcc, q.mnc, q.scramb_init), c
    assert len(ref.native_events) == len(got.native_events)
    for key in ("carrier", "kind", "a", "b", "c", "d", "payload"):
        a = np.concatenate([e[key] for e in ref.native_events])
        b = np.concatenate([e[key] for e in got.native_events])
        assert np.array_equal(a, b), key


def _carrier_state(rx):
    return [(c.stats.bursts, c.stats.slots, c.stats.crc_ok,
             c.stats.crc_wrong, c.time.tn, c.time.fn, c.time.mn,
             c.colour_code, c.mcc, c.mnc, c.scramb_init)
            for c in rx.carriers]


def test_prod_wideband_matches_jax(tmp_path, monkeypatch):
    """TestProdConfig: same per-carrier stats, TDMA state, cell identity
    and concatenated native event arrays as the JAX receiver, with the
    capture cut in half and in uneven calls (one that completes no BLOCK
    of the overlap-save stream, a final short one); the uneven cuts
    leave every carrier as one whole-capture call does."""
    from tetra_tpu_torch import rx_multi
    sys.path.insert(0, str(ROOT / "tools"))
    import bench_mc_e2e as B
    from tetra_tpu.phy import dqpsk, channelizer
    from tetra_tpu.io import stream as stream_mod
    from tetra_tpu.umac.native_exec import EV
    bits, n_enc = B.mixed_batch(8, 8, enc_frac=0.25)
    assert n_enc == 2
    ksf = tmp_path / "keys.txt"
    ksf.write_text(B.KEYSTORE)
    base = dqpsk.modulate(bits, sps=2)
    wide = channelizer.synthesize_wideband_fft(base, np.arange(8), 8)
    packed = stream_mod.quantize_iq4c(wide.real, wide.imag)
    S, BLOCK = len(packed), 25 * 8
    mid = (S // 2 // BLOCK) * BLOCK
    kw = dict(fs=2e5, pfb_channels=np.arange(8, dtype=np.int32), n_chan=8,
              control_plane="native", keystore_path=str(ksf))

    completed = []        # per call: did it complete a BLOCK
    take = rx_multi._OverlapSave.take

    def counted_take(self, *a):
        t = take(self, *a)
        completed.append(t is not None)
        return t
    monkeypatch.setattr(rx_multi._OverlapSave, "take", counted_take)

    def run(rx, cuts):
        completed.clear()
        for k in range(len(cuts) - 1):
            rx.process_iq4c(packed[cuts[k]:cuts[k + 1]],
                            final=k == len(cuts) - 2)
        return rx

    whole = run(MultiCarrierReceiver([], device=CPU, **kw), [0, S])
    for cuts in ([0, S // 2, S],
                 [0, 150, mid, mid + BLOCK - 1, S - 37, S]):
        ref = run(JaxReceiver([], **kw), cuts)
        got = run(MultiCarrierReceiver([], device=CPU, **kw), cuts)
        assert completed == ([True, True] if len(cuts) == 3
                             else [False, True, False, True, True])
        _same_receivers(ref, got, 8)
        assert _carrier_state(got) == _carrier_state(whole), cuts
        assert all(c.stats.crc_wrong == 0 and c.stats.crc_ok > 0
                   for c in got.carriers)
        kinds = np.concatenate([e["kind"] for e in got.native_events])
        assert (kinds == EV.TRAFFIC).sum() > 0 and \
            (kinds == EV.TLSDU).sum() > 0


def test_bits_entry_matches_jax():
    """Pre-demodulated corrupted streams, uneven chunks, pipelining."""
    B = 6
    streams = [make_stream(7000 + b, n_frames=4) for b in range(B)]
    L = min(len(s) for s in streams)
    batch = np.stack([s[:L] for s in streams])
    cuts = [0, 999, L // 2, L // 2 + 20, L]
    ref = JaxReceiver(np.zeros(B, np.float32), fs=25e3 * B,
                      control_plane="native")
    got = MultiCarrierReceiver([], fs=25e3 * B, pfb_channels=np.arange(B),
                               control_plane="native", device=CPU)
    for k in range(len(cuts) - 1):
        last = k == len(cuts) - 2
        for rx in (ref, got):
            rx.process_bits(batch[:, cuts[k]:cuts[k + 1]], final=last)
    _same_receivers(ref, got, B)


@pytest.mark.parametrize("plane", ["native", "python"])
@pytest.mark.parametrize("front_end", ["pfb", "mixer"])
def test_construction_per_plane(front_end, plane, monkeypatch):
    """With a keystore, the native plane builds no TetraReceiver and
    parses the keystore once (for the C++ walk): each carrier is a
    CarrierState. The Python plane builds one TetraReceiver per carrier,
    each parsing the keystore."""
    from tetra_tpu_torch import prod_fixture, rx
    from tetra_tpu_torch.crypto import crypto
    built, parsed = [], []
    init, load = rx.TetraReceiver.__init__, crypto.load_keystore

    def counted_init(self, *a, **k):
        built.append(self)
        init(self, *a, **k)

    def counted_load(*a, **k):
        parsed.append(a[0])
        return load(*a, **k)
    monkeypatch.setattr(rx.TetraReceiver, "__init__", counted_init)
    monkeypatch.setattr(crypto, "load_keystore", counted_load)
    monkeypatch.setattr(rx, "load_keystore", counted_load)
    kw = (dict(offsets_hz=[], pfb_channels=np.arange(8), n_chan=8)
          if front_end == "pfb" else
          dict(offsets_hz=(np.arange(8) - 3.5) * 25e3))
    with prod_fixture.keystore_file() as ks:
        got = MultiCarrierReceiver(fs=2e5, keystore_path=ks,
                                   control_plane=plane, device=CPU, **kw)
    assert len(got.carriers) == 8
    if plane == "native":
        assert built == [] and parsed == [ks]
        assert all(type(c) is rx.CarrierState for c in got.carriers)
    else:
        assert built == got.carriers and parsed == [ks] * 8
        assert all(type(c) is rx.TetraReceiver for c in got.carriers)


def test_native_dumpdir_made_at_construction(tmp_path):
    """A native receiver with dumpdir creates dumpdir/carrier<i> for each
    carrier when it is built, as the Python plane's receivers do."""
    got = MultiCarrierReceiver([], fs=2e5, pfb_channels=np.arange(3),
                               n_chan=8, control_plane="native",
                               dumpdir=str(tmp_path / "d"), device=CPU)
    want = [str(tmp_path / "d" / f"carrier{i}") for i in range(3)]
    assert [c.dumpdir for c in got.carriers] == want
    assert sorted(str(p) for p in (tmp_path / "d").iterdir()) == want


def test_import_is_jax_free(tmp_path):
    """A fresh interpreter imports every module of the port, runs a
    2-carrier wideband slice with traffic dumps, voice decode, GSMTAP
    and a TL-SDU sink, the mixer bank on the 2-cell off-grid capture,
    the carrier scan, the receiver CLI on a bits file, the self-test,
    the transmitter and the equaliser, and never loads jax nor any
    tetra_tpu module."""
    code = """
import importlib, pkgutil, sys
import numpy as np
import tetra_tpu_torch
for m in pkgutil.walk_packages(tetra_tpu_torch.__path__, "tetra_tpu_torch."):
    importlib.import_module(m.name)
import tetra_tpu_torch.rx_multi as rm
from tetra_tpu_torch import prod_fixture
bits, _ = prod_fixture.mixed_bits(8, 0.25)
packed = prod_fixture.wideband_capture(bits[:, :12000])
sdus = []
with prod_fixture.keystore_file() as ks:
    mrx = rm.MultiCarrierReceiver(
        [], fs=2e5, pfb_channels=[2, 7], n_chan=8, device="cpu",
        control_plane="native",
        keystore_path=ks, dumpdir=sys.argv[1], decode_voice=True,
        gsmtap_host="127.0.0.1", tl_sdu_sink=lambda *a: sdus.append(a))
    stats = mrx.process_iq4c(packed)
assert all(s.crc_ok > 0 and s.crc_wrong == 0 for s in stats), stats
assert sdus
import pathlib
assert list(pathlib.Path(sys.argv[1]).rglob("voice_*.cod"))
from tetra_tpu_torch import receiver, scan
from tetra_tpu_torch.io.sdr import RtlTcpSource
fxm = prod_fixture.load_mixer()
wide, offs, fs = prod_fixture.small_capture(fxm)
stats = rm.MultiCarrierReceiver(offs, fs=fs, device="cpu").process_iq(wide)
assert all(s.crc_ok > 0 and s.crc_wrong == 0 for s in stats), stats
res, _ = scan.scan(RtlTcpSource._to_complex(fxm["scan_u8"]),
                   float(fxm["scan_fs"]), device="cpu")
assert sum(r["confirmed"] for r in res) == 2, res
cap = pathlib.Path(sys.argv[1]) / "cap.bits"
prod_fixture.rx_small_bits().tofile(cap)
receiver.main(["--file", str(cap), "--device", "cpu"], log=lambda *a: None)
import torch
from tetra_tpu_torch import selftest, steady_fixture as sf, tx
from tetra_tpu_torch.phy import equalize
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):
    assert selftest.punct_test("cpu") == 0
assert selftest.loopback_soak(8, device="cpu") == 0
assert tx.make_schf_bursts(np.zeros((2, 268), np.int8),
                           np.zeros((2, 14), np.int8), 3, "cpu").shape == (2, 510)
re, im = sf.eq_capture(8, [0, 2])
slots = equalize.demodulate_hard_eq_slotwise_ri(
    torch.as_tensor(re), torch.as_tensor(im), 64, phase_bit=64)
assert slots.shape == (2, 64, 510)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tetra_tpu"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


class _TwoRankMesh:
    """Rank 0 of a two-rank carrier mesh, without a process group: the
    receiver raises before any collective would run."""
    mesh_dim_names = ("car",)
    shape = (2,)

    def get_local_rank(self, dim):
        return 0


@pytest.mark.parametrize("kwargs", [
    dict(entry="process_iq4c"),
    dict(entry="process_iq8"),
])
def test_unported_options_raise(kwargs):
    """The PFB wideband entries on a multi-rank mesh raise: tetra_tpu's
    fused PFB chunk is not carrier-sharded, and on a multi-process mesh
    it parses garbage (tests/test_torch_distributed.py runs the mixer
    bank, which decodes there, and this entry on real ranks)."""
    rx = MultiCarrierReceiver([], fs=2e5, pfb_channels=np.arange(8),
                              n_chan=8, control_plane="native",
                              mesh=_TwoRankMesh(), device=CPU)
    raw = np.zeros(40_000 if kwargs["entry"] == "process_iq4c" else 80_000,
                   np.uint8 if kwargs["entry"] == "process_iq4c" else np.int8)
    with pytest.raises(NotImplementedError, match="multi-rank"):
        getattr(rx, kwargs["entry"])(raw)


def _prefetch_runs(entry: str, monkeypatch, early: bool, g_slack=None):
    """The 8-carrier slice through the native plane in 4 chunks (final
    on the last), with or without the early fetch; returns (receiver,
    handles prefetched, handles re-run)."""
    from tetra_tpu_torch import fastpath, prod_fixture
    bits, _ = prod_fixture.mixed_bits(8, 0.25)
    bits = bits[:, :16_000]
    fetched, reruns = [], []
    pf, rr = fastpath.FastChunkPipeline.prefetch, \
        fastpath.FastChunkPipeline._overflow_rerun
    with monkeypatch.context() as m:
        m.setattr(fastpath.FastChunkPipeline, "prefetch",
                  lambda self, h: (fetched.append(h), pf(self, h))[1])
        m.setattr(fastpath.FastChunkPipeline, "_overflow_rerun",
                  lambda self, h: (reruns.append(h), rr(self, h))[1])
        if not early:
            m.setattr(MultiCarrierReceiver, "_prefetch_pending",
                      lambda self: None)
        if g_slack is not None:
            m.setattr(fastpath, "G_SLACK", g_slack)
        rx = MultiCarrierReceiver([], fs=2e5, pfb_channels=np.arange(8),
                                  n_chan=8, control_plane="native",
                                  device=CPU)
        if entry == "bits":
            feed, call = bits, rx.process_bits
        else:
            feed, call = prod_fixture.wideband_capture(bits), rx.process_iq4c
        cuts = np.linspace(0, feed.shape[-1], 5).astype(int)
        for k in range(4):
            call(feed[..., cuts[k]:cuts[k + 1]], final=k == 3)
    return rx, fetched, reruns


@pytest.mark.parametrize("entry", ["bits", "iq4c"])
def test_early_fetch_keeps_events_and_stats(entry, monkeypatch):
    """The pending bundle's early fetch changes no event and no stat, on
    process_bits and on process_iq4c; the fetch is issued."""
    ref, fetched, _ = _prefetch_runs(entry, monkeypatch, early=False)
    assert not fetched
    got, fetched, _ = _prefetch_runs(entry, monkeypatch, early=True)
    assert len(fetched) >= 2
    _same_receivers(ref, got, 8)
    assert all(c.stats.crc_ok > 0 for c in got.carriers)


def test_early_fetch_dropped_on_overflow_rerun(monkeypatch):
    """A row budget too small for every chunk forces _overflow_rerun on
    chunks whose bundles were fetched early: the collect parses each
    re-run's bundle, not the stale fetch, and the events and stats equal
    a run with the default budget."""
    ref, _, reruns = _prefetch_runs("bits", monkeypatch, early=True)
    assert not reruns
    got, fetched, reruns = _prefetch_runs("bits", monkeypatch, early=True,
                                          g_slack=-6)
    assert reruns and any(h in fetched for h in reruns)
    _same_receivers(ref, got, 8)


def _imports_of_jax_package(path: pathlib.Path) -> list:
    import ast
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        bad += [f"{path.name}:{node.lineno} {n}" for n in names
                if n == "tetra_tpu" or n.startswith("tetra_tpu.")]
    return bad


def test_port_sources_import_nothing_of_jax_package():
    """No module of the port, nor chip_smoke.py, nor the port's profiling
    and bench tools, nor the rank functions of its multi-rank tests
    imports tetra_tpu (as opposed to tetra_tpu_torch); the transmitter,
    self-test, equaliser and parallel modules are among them."""
    files = sorted((ROOT / "tetra_tpu_torch").rglob("*.py"))
    for mod in ("tx", "selftest", "testpdu", "phy/equalize",
                "parallel/mesh", "parallel/collectives", "parallel/launch",
                "parallel/dist_worker", "parallel/dryrun"):
        assert ROOT / "tetra_tpu_torch" / f"{mod}.py" in files, mod
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "rtl_tcp_mock.py",
              ROOT / "tests" / "_torch_ranks.py",
              *sorted((ROOT / "tools").glob("profile_torch_*.py")),
              *sorted((ROOT / "tools").glob("bench_torch_*.py"))]
    assert len(files) > 30
    bad = [b for f in files for b in _imports_of_jax_package(f)]
    assert not bad, bad


def test_cuda_request_without_card_raises():
    import torch
    from tetra_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
