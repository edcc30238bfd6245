"""The Python control plane of the PyTorch port's MultiCarrierReceiver
(control_plane="python", the default) vs tetra_tpu's on the CPU.

The capture is the 8-carrier production fixture with the keystore
(prod_fixture.mixed_bits(8, 0.25): 2 TEA1 carriers), fed in two chunks
as per-carrier bits and in the three wideband ingest formats: companded
4+4-bit (iq4c), interleaved int8 (iq8) and uniform 4+4-bit (iq4). Per
carrier, the log lines, stats, TDMA time, cell identity, the chained
TL-SDU sink's calls, GSMTAP packets and the dump and voice files must be
identical to the JAX Python plane's (its dump writer raises on an NDB
slot's 216-bit traffic row, so its side runs under
make_torch_fixture.jax_short_row_dumps). The port's Python plane must
also agree with its own native plane, and the defrag capture's TUN
packets with the JAX Python plane's.
"""
import pathlib
import sys

import numpy as np
import pytest

from tests._torch_util import CPU

from tetra_tpu.rx_multi import MultiCarrierReceiver as JaxReceiver

from tetra_tpu_torch import prod_fixture
from tetra_tpu_torch.io import stream
from tetra_tpu_torch.phy import channelizer, dqpsk
from tetra_tpu_torch.rx_multi import MultiCarrierReceiver

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import make_torch_fixture  # noqa: E402
import udp_sink  # noqa: E402

N_CAR = 8
FORMATS = ["bits", "iq4c", "iq8", "iq4"]


@pytest.fixture(scope="module")
def inputs():
    """The fixture's bits [8, L] and the wideband capture in each
    ingest format: {fmt: (receiver method name, data)}."""
    bits, n_enc = prod_fixture.mixed_bits(N_CAR, 0.25)
    assert n_enc == 2
    wide = channelizer.synthesize_wideband_fft(dqpsk.modulate(bits, sps=2),
                                               np.arange(N_CAR), N_CAR)
    sig = float(np.sqrt(np.mean(np.abs(wide) ** 2) / 2))
    qr, qi = stream.quantize_iq(wide.real / (6 * sig), wide.imag / (6 * sig))
    return {"bits": ("process_bits", bits),
            "iq4c": ("process_iq4c", stream.quantize_iq4c(wide.real,
                                                          wide.imag)),
            "iq8": ("process_iq8", np.stack([qr, qi], 1).reshape(-1)),
            "iq4": ("process_iq4", stream.quantize_iq4(
                wide.real / (3 * sig), wide.imag / (3 * sig)))}


def _run(cls, method, data, ks, dumpdir=None, **kw):
    """One receiver over `data` in two chunks (final=False, then True)
    with per-carrier logs and a TL-SDU sink, and with `dumpdir` also
    dumps, voice and GSMTAP to a local sink: (receiver, logs, files,
    packets, sink calls)."""
    logs = [[] for _ in range(N_CAR)]
    calls = []
    sink = lambda c, pd, pt, b: calls.append(
        (int(c), int(pd), int(pt), np.asarray(b).tobytes()))
    egress = {}
    if dumpdir is not None:
        egress = dict(dumpdir=str(dumpdir), decode_voice=True,
                      gsmtap_host="127.0.0.1")
    with udp_sink.collect() as udp:
        rx = cls([], fs=25e3 * N_CAR, pfb_channels=np.arange(N_CAR),
                 n_chan=N_CAR, keystore_path=ks, tl_sdu_sink=sink,
                 log=[prod_fixture.line_logger(lg) for lg in logs],
                 **egress, **kw)
        # the native plane's carriers hold no sink of their own
        for g in [rx.gsmtap] + [getattr(c, "gsmtap", None)
                                for c in rx.carriers]:
            if g is not None:
                g.addr = udp.addr
        cut = (data.shape[-1] // 2) & ~127
        getattr(rx, method)(data[..., :cut], final=False)
        getattr(rx, method)(data[..., cut:], final=True)
    files = prod_fixture.read_tree(dumpdir) if dumpdir else {}
    return rx, logs, files, udp.packets, calls


# the format whose runs also carry dumps, voice and GSMTAP
EGRESS = "iq4c"


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """fmt -> (JAX Python plane run, port Python plane run), each made
    once (memoised across the tests of this file)."""
    done = {}

    def get(fmt):
        if fmt not in done:
            method, data = inputs[fmt]
            tmp = tmp_path_factory.mktemp(fmt)
            dirs = ((tmp / "jax", tmp / "port") if fmt == EGRESS
                    else (None, None))
            with prod_fixture.keystore_file() as ks:
                with make_torch_fixture.jax_short_row_dumps():
                    ref = _run(JaxReceiver, method, data, ks, dirs[0])
                got = _run(MultiCarrierReceiver, method, data, ks, dirs[1],
                           device=CPU)
            done[fmt] = (ref, got)
        return done[fmt]
    return get


def _stats(rx):
    return [(c.stats.bursts, c.stats.slots, c.stats.crc_ok,
             c.stats.crc_wrong, c.time.tn, c.time.fn, c.time.mn,
             c.colour_code, c.mcc, c.mnc, c.scramb_init)
            for c in rx.carriers]


@pytest.mark.parametrize("fmt", FORMATS)
def test_logs_stats_and_sink_calls(fmt, runs):
    (ref, rlogs, _, _, rcalls), (got, glogs, _, _, gcalls) = runs(fmt)
    assert got.control_plane == "python"
    assert _stats(got) == _stats(ref)
    for c in range(N_CAR):
        assert glogs[c] == rlogs[c], c
        assert repr(got.carriers[c].umac.events) == \
            repr(ref.carriers[c].umac.events), c
    assert all(c.stats.crc_ok > 60 for c in got.carriers)
    assert sum(c.stats.crc_wrong for c in got.carriers) == 0
    assert sum("DECRYPTED" in ln for ln in glogs[7]) > 0
    assert len(rcalls) > 50 and gcalls == rcalls


def test_gsmtap_packets(runs):
    (_, _, _, want, _), (_, _, _, got, _) = runs(EGRESS)
    assert len(want) > 500 and got == want


def test_dump_and_voice_files(runs):
    (_, _, want, _, _), (_, _, got, _, _) = runs(EGRESS)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    assert sum(k.endswith(".cod") for k in got) > 8


@pytest.mark.parametrize("fmt", FORMATS)
def test_python_plane_equals_native_plane(fmt, runs, inputs, tmp_path):
    """The port's two planes on the same input: identical stats, TDMA
    time, cell identity and TL-SDU sink calls, and on the egress format
    the same dump and voice files (the native plane writes SSI 0 in the
    .txt files, the Python plane the slot's SSI: those are compared by
    line count)."""
    _, (py, _, pfiles, _, pcalls) = runs(fmt)
    method, data = inputs[fmt]
    with prod_fixture.keystore_file() as ks:
        nat, _, nfiles, _, ncalls = _run(
            MultiCarrierReceiver, method, data, ks,
            tmp_path if fmt == EGRESS else None, control_plane="native",
            device=CPU)
    assert _stats(nat) == _stats(py)
    assert sorted(ncalls) == sorted(pcalls)
    assert list(nfiles) == list(pfiles)
    for k, v in pfiles.items():
        if k.endswith(".txt"):
            assert v.count(b"\n") == nfiles[k].count(b"\n"), k
        else:
            assert nfiles[k] == v, k


def test_tun_writes(monkeypatch):
    """The defrag capture (an SNDCP IP packet in four fragments per
    carrier) cut inside the fragment chain: each carrier's TUN packets
    equal the JAX Python plane's."""
    from tests.test_torch_egress import _defrag_capture
    from tetra_tpu.rx import TetraReceiver
    from tetra_tpu_torch.io.tun import TunDevice
    batch, ips = _defrag_capture()
    cut = (batch.shape[1] // 2) & ~63
    # patched before the receivers exist: the LLC binds _ip_out then
    want = {c: [] for c in range(3)}
    who = {}
    monkeypatch.setattr(TetraReceiver, "_ip_out",
                        lambda self, pkt: want[who[id(self)]].append(pkt))
    ref = JaxReceiver([], fs=75e3, pfb_channels=np.arange(3), n_chan=3)
    who.update({id(rx): c for c, rx in enumerate(ref.carriers)})
    written = []
    monkeypatch.setattr(TunDevice, "write",
                        lambda self, pkt: written.append((self, pkt)))
    got = MultiCarrierReceiver([], fs=75e3, pfb_channels=np.arange(3),
                               device=CPU)
    for rx in (ref, got):
        rx.process_bits(batch[:, :cut], final=False)
        rx.process_bits(batch[:, cut:], final=True)
    per = {c: [p for dev, p in written if dev is got.carriers[c]._tun]
           for c in range(3)}
    assert per == want
    assert [per[c] for c in range(3)] == [[ip] for ip in ips]


def test_plane_options():
    """The default plane is "python"; the soft demod refuses it (the JAX
    package's check); an unknown plane raises."""
    kw = dict(fs=2e5, pfb_channels=np.arange(N_CAR), n_chan=N_CAR,
              device=CPU)
    assert MultiCarrierReceiver([], **kw).control_plane == "python"
    with pytest.raises(ValueError):
        MultiCarrierReceiver([], demod="soft", **kw)
    with pytest.raises(ValueError):
        MultiCarrierReceiver([], control_plane="rust", **kw)
    assert MultiCarrierReceiver([], demod="soft", control_plane="native",
                                **kw).control_plane == "native"
