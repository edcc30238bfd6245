"""The production receiver's egress in the PyTorch port vs tetra_tpu's
native plane on the CPU: traffic dumps and TCH/S voice files (dumpdir +
decode_voice), GSMTAP packets, TL-SDU sink calls and TUN writes.

The capture is the 8-carrier production fixture with the keystore
(prod_fixture.mixed_bits(8, 0.25): 2 TEA1 carriers, so the walk supplies
voice keystreams), under demod="hard" and demod="soft"; every file name
and byte, every packet and every sink call must be identical. The JAX
package raises on an NDB slot's 216-bit traffic row in its dump writer;
its side runs with make_torch_fixture.jax_short_row_dumps, which writes
such a row as the port does and decodes its voice with the JAX code.
"""
import pathlib
import sys

import numpy as np
import pytest

from tests._torch_util import CPU

from tetra_tpu.rx_multi import MultiCarrierReceiver as JaxReceiver
from tetra_tpu.umac import native_exec

from tetra_tpu_torch import prod_fixture
from tetra_tpu_torch.rx_multi import MultiCarrierReceiver

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import make_torch_fixture  # noqa: E402
import udp_sink  # noqa: E402

pytestmark = pytest.mark.skipif(not native_exec.available(),
                                reason="native library unavailable")


def _run(cls, packed, ks, dumpdir, **kw):
    """One receiver over the capture in two chunks; returns (receiver,
    files, packets, sink calls)."""
    calls = []
    sink = lambda c, pd, pt, bits: calls.append(
        (int(c), int(pd), int(pt), np.asarray(bits).tobytes()))
    with udp_sink.collect() as udp:
        rx = cls([], fs=2e5, pfb_channels=np.arange(8), n_chan=8,
                 keystore_path=ks, dumpdir=str(dumpdir), decode_voice=True,
                 gsmtap_host="127.0.0.1", tl_sdu_sink=sink,
                 control_plane="native", **kw)
        rx.gsmtap.addr = udp.addr
        half = len(packed) // 2
        rx.process_iq4c(packed[:half], final=False)
        rx.process_iq4c(packed[half:], final=True)
    return rx, prod_fixture.read_tree(dumpdir), udp.packets, calls


@pytest.fixture(scope="module", params=["hard", "soft"])
def runs(request, tmp_path_factory):
    demod = request.param
    bits, n_enc = prod_fixture.mixed_bits(8, 0.25)
    assert n_enc == 2
    packed = prod_fixture.wideband_capture(bits)
    tmp = tmp_path_factory.mktemp(demod)
    with prod_fixture.keystore_file() as ks:
        with make_torch_fixture.jax_short_row_dumps():
            ref = _run(JaxReceiver, packed, ks, tmp / "jax", demod=demod)
        got = _run(MultiCarrierReceiver, packed, ks, tmp / "port",
                   demod=demod, device=CPU)
    return ref, got


def test_traffic_and_voice_files(runs):
    (_, want, _, _), (rx, got, _, _) = runs
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    # every carrier dumps its traffic slots, full and NDB halves, and
    # decodes them to 35-byte voice frames
    cod = [k for k in got if k.endswith(".cod")]
    assert len({k.split("/")[0] for k in cod}) == 8
    out = sum(len(v) for k, v in got.items() if k.endswith(".out"))
    assert out // 1380 * 35 == sum(len(got[k]) for k in cod) > 0


def test_files_match_fixture(runs):
    """Every plain carrier writes the fixture's plain-row files and every
    encrypted carrier its encrypted-row files (what chip_smoke.py holds
    the 1024-carrier pass to)."""
    _, (_, got, _, _) = runs
    want = prod_fixture.expected_traffic(prod_fixture.load())
    for c in range(8):
        mine = {k.split("/", 1)[1]: v for k, v in got.items()
                if k.startswith(f"carrier{c}/")}
        assert mine == want["enc" if c >= 6 else "plain"], c


def test_voice_keystream_applied(runs):
    """The TEA1 carriers' voice differs from the plain carriers' though
    their traffic bits are the same rows."""
    _, (_, got, _, _) = runs
    plain = {k.split("/", 1)[1]: v for k, v in got.items()
             if k.startswith("carrier0/")}
    enc = {k.split("/", 1)[1]: v for k, v in got.items()
           if k.startswith("carrier7/")}
    assert plain.keys() == enc.keys()
    for k in plain:
        if k.endswith(".cod"):
            assert plain[k] != enc[k], k


def test_gsmtap_packets(runs):
    (_, _, want, _), (_, _, got, _) = runs
    assert len(want) > 500
    assert got == want


def test_tl_sdu_sink_calls(runs):
    (_, _, _, want), (_, _, _, got) = runs
    assert len(want) > 50
    assert got == want


def _defrag_capture():
    """tests/test_rx_multi.py::TestNativePayloadEgress's capture: per
    carrier an SNDCP IP packet fragmented over four SCH/F slots plus a
    CMCE BL-UDATA slot."""
    import jax.numpy as jnp
    from tests.test_native_umac import make_al_udata
    from tetra_tpu import testpdu, tx
    from tetra_tpu.ops.scramble import scramb_get_init
    from tetra_tpu.utils.bits import uint_to_bits
    rng = np.random.default_rng(17)
    init = jnp.uint32(scramb_get_init(262, 42, 1))
    aach = testpdu.make_access_assign_bits()
    sb = np.asarray(tx.make_sync_burst(testpdu.make_sync_pdu(
        cc=1, mcc=262, mnc=42), testpdu.make_sysinfo_pdu(), aach, init),
        np.uint8)
    schf = lambda p: np.asarray(tx.make_schf_burst(p, aach, init), np.uint8)
    streams, ips = [], []
    for c in range(3):
        ip = bytes([0x45, 0, 0, 32, c]) + bytes(
            rng.integers(0, 256, 27).astype(np.uint8))
        tl = np.concatenate([uint_to_bits(4, 3), uint_to_bits(0, 16),
                             np.unpackbits(np.frombuffer(ip, np.uint8))]
                            ).astype(np.int8)
        cuts = [0, 70, 140, 210, len(tl)]
        parts = [rng.integers(0, 2, 40 + 11 * c).astype(np.uint8), sb, sb]
        parts += [schf(testpdu.make_resource_pdu(
            ssi=0x600 + c, sdu_bits=make_al_udata(k == 3, ns=5, ss=k + 1,
                                                  payload=tl[cuts[k]:
                                                             cuts[k + 1]])))
            for k in range(4)]
        parts.append(schf(testpdu.make_resource_pdu(
            ssi=0x700 + c, sdu_bits=testpdu.make_bl_udata(
                testpdu.make_mle_cmce_dsetup()))))
        parts.append(np.zeros(640, np.uint8))
        streams.append(np.concatenate(parts))
        ips.append(ip)
    n_bits = min(len(s) for s in streams)
    return np.stack([s[:n_bits] for s in streams]), ips


def test_tun_writes(monkeypatch):
    """Defrag-reassembled SNDCP packets go to each carrier's tun0 as the
    JAX native plane writes them (a cut inside the fragment chain)."""
    from tetra_tpu.rx import TetraReceiver
    from tetra_tpu_torch.io.tun import TunDevice
    from tetra_tpu_torch.rx import CarrierState
    batch, ips = _defrag_capture()
    cut = (batch.shape[1] // 2) & ~63
    want = {c: [] for c in range(3)}
    ref = JaxReceiver(np.zeros(3, np.float32), fs=75e3,
                      control_plane="native")
    who = {id(rx): c for c, rx in enumerate(ref.carriers)}
    monkeypatch.setattr(TetraReceiver, "_ip_out",
                        lambda self, pkt: want[who[id(self)]].append(pkt))
    written = []
    monkeypatch.setattr(TunDevice, "write",
                        lambda self, pkt: written.append((self, pkt)))
    got = MultiCarrierReceiver([], fs=75e3, pfb_channels=np.arange(3),
                               control_plane="native", device=CPU)
    for rx in (ref, got):
        rx.process_bits(batch[:, :cut], final=False)
        rx.process_bits(batch[:, cut:], final=True)
    # the native plane keeps each carrier's tun0 writer in its CarrierState
    assert all(type(c) is CarrierState for c in got.carriers)
    per = {c: [p for dev, p in written if dev is got.carriers[c]._tun]
           for c in range(3)}
    assert per == want
    assert [per[c] for c in range(3)] == [[ip] for ip in ips]
