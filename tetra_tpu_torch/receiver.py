"""Live receiver pipeline CLI — the receiver1 / receiver1udp analogue
(port of tetra_tpu.receiver).

Reference behaviour: shell pipelines `demod | float_to_bits | tetra-rx`
over FIFOs (src/receiver1:8) or UDP via socat (src/receiver1udp:71-78).
Here the whole chain runs in one process: UDP, file, audio-card or
rtl_tcp ingest, the front end and the FEC on the device (the card
unless --device says otherwise), streaming burst sync, the control
plane on the host.

Usage:
  python -m tetra_tpu_torch.receiver --udp 42001 [--fmt iq]
  python -m tetra_tpu_torch.receiver --file capture.cfile
  python -m tetra_tpu_torch.receiver --file capture.bits -d DUMPDIR -k KEYSTORE
  python -m tetra_tpu_torch.receiver --audio - --calibration 5000
  python -m tetra_tpu_torch.receiver --rtltcp sdr-host --freq 392.5e6 \\
      --carriers auto          # live hardware, every carrier in the span
  ... --device cpu             # the plain versions on the CPU

The --rtltcp mode is the osmosdr/fcdp live-demod analogue (reference
src/demod/osmosdr-tetra_demod_fft.py): I/Q comes from any rtl-sdr via
the stock rtl_tcp daemon, carriers are found by measurement instead of
GUI clicks (tetra_tpu_torch.scan), and all of them decode from the one
wideband stream: carriers on the 25 kHz grid of an even channel count
through the polyphase filterbank, all others through the mixer bank.
"""
from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np

from tetra_tpu_torch.io.inputs import capture_to_bits, load_capture
from tetra_tpu_torch.io.udp import TELIVE_PORT, UdpSource
from tetra_tpu_torch.rx import TetraReceiver

__all__ = ["run_udp", "run_audio", "run_rtltcp", "main"]


def run_udp(rx: TetraReceiver, port: int, fmt: str, sps: int,
            chunk_symbols: int = 36_000, timeout: float = 5.0):
    """Consume UDP datagrams, batching into ~1 s chunks before the
    device pipeline (amortises dispatch like the reference's FIFO
    buffering)."""
    dtype = {"iq": np.complex64, "float": np.float32, "bits": np.uint8}[fmt]
    src = UdpSource(port, dtype=dtype, timeout=timeout)
    pending: list[np.ndarray] = []
    pending_n = 0
    try:
        for chunk in src.stream():
            pending.append(chunk)
            pending_n += len(chunk)
            if pending_n >= chunk_symbols:
                data = np.concatenate(pending)
                pending, pending_n = [], 0
                rx.process_bits(capture_to_bits(fmt, data, sps=sps,
                                                device=rx.device))
    except KeyboardInterrupt:
        pass
    finally:
        if pending:
            rx.process_bits(capture_to_bits(fmt, np.concatenate(pending),
                                            sps=sps, device=rx.device))
        src.close()


def run_audio(rx: TetraReceiver, args):
    """fcdp audio-card ingest (reference src/demod/fcdp-tetra_demod.py):
    stereo PCM I/Q from a pipe/file -> on the device, mix at the
    calibration offset + 25 kHz low-pass + polyphase resample to 36 kHz
    (phy.channelizer) -> demod -> streaming decode."""
    import torch
    from tetra_tpu_torch.io.audio import AudioPipeSource
    from tetra_tpu_torch.phy import channelizer, dqpsk

    src = AudioPipeSource(args.audio, sample_rate=args.audio_rate,
                          fmt=args.audio_fmt, swap_iq=args.swap_iq)
    cal = args.calibration
    head = None
    if str(cal).lower() == "auto":
        # measure the offset off the first second (the fcdp FFT-plot
        # click, by measurement) and keep those samples for decoding
        from tetra_tpu_torch import scan as scanner
        head = src.read(int(args.audio_rate))
        offs, snrs, _ = scanner.detect_carriers(head, args.audio_rate,
                                                device=rx.device)
        cal = float(offs[0]) if len(offs) else 0.0
        print(f"calibration auto: {cal:+.0f} Hz"
              + (f" (snr {snrs[0]:.1f} dB)" if len(offs) else " (no carrier)"),
              file=sys.stderr)
    offsets = np.asarray([float(cal)], np.float32)
    try:
        chunks = src.stream(chunk=int(args.audio_rate))
        if head is not None and len(head):
            chunks = itertools.chain([head], chunks)
        for iq in chunks:
            re = torch.as_tensor(np.real(iq).astype(np.float32),
                                 device=rx.device)
            im = torch.as_tensor(np.imag(iq).astype(np.float32),
                                 device=rx.device)
            cr, ci = channelizer.channelize_ri(re, im, offsets,
                                               fs=args.audio_rate)
            bits = dqpsk.demodulate_hard_ri(cr, ci, sps=2)[0]
            rx.process_bits(bits.cpu().numpy(), final=False)
    except KeyboardInterrupt:
        pass
    finally:
        rx.process_bits(np.zeros(0, np.uint8), final=True)
        src.close()


def run_rtltcp(args, log=None):
    """Live multi-carrier receive from an rtl_tcp server: scan (or take
    explicit offsets), then stream chunks through the batched wideband
    chain until interrupted or --secs elapses. log: the receivers' log
    (one callable, or one per carrier; none by default, as in
    tetra_tpu). Returns the MultiCarrierReceiver, or [] when the scan
    confirms no carrier."""
    from tetra_tpu_torch.device import resolve_device
    from tetra_tpu_torch.io.sdr import RTL_TCP_PORT, RtlTcpSource
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver

    dev = resolve_device(args.device)
    host, _, port = args.rtltcp.partition(":")
    src = RtlTcpSource(host, int(port) if port else RTL_TCP_PORT)
    print(f"rtl_tcp: tuner {src.tuner_name}", file=sys.stderr)
    src.configure(freq_hz=args.freq or 0.0, rate_hz=args.rate,
                  gain_db=args.gain, ppm=args.ppm)
    fs = args.rate

    if args.carriers == "auto":
        from tetra_tpu_torch import scan as scanner
        iq0 = src.read(int(fs))  # 1 s scan capture
        results, _ = scanner.scan(iq0, fs, confirm=True, device=dev)
        offsets = [r["offset_hz"] for r in results if r["confirmed"]]
        print(f"scan: {len(offsets)} confirmed carrier(s) at "
              f"{[f'{o / 1e3:+.0f}k' for o in offsets]}", file=sys.stderr)
        if not offsets:
            src.close()
            return []
    else:
        offsets = [float(x) for x in args.carriers.split(",")]

    if args.soft and args.control_plane != "native":
        print("--soft rides the fastpath; forcing --control-plane native",
              file=sys.stderr)
        args.control_plane = "native"
    rx_kw = dict(keystore_path=args.keystore, dumpdir=args.dumpdir,
                 gsmtap_host=args.gsmtap,
                 control_plane=args.control_plane,
                 decode_voice=args.voice,
                 demod="soft" if args.soft else "hard", log=log, device=dev)
    # grid-aligned carriers route through the polyphase filterbank:
    # O(T*taps + DFT) instead of O(C*T). On-grid tolerance 100 Hz: the
    # PFB snaps to the bin centre without derotating the residual CFO,
    # and 100 Hz is ~2°/symbol at 18 ksym/s (negligible demod margin);
    # larger residuals (tuner ppm error) take the exact mixer path
    n_chan = int(round(fs / 25_000.0))
    on_grid = (n_chan % 2 == 0
               and abs(fs - n_chan * 25_000.0) < 1e-3
               and len(offsets) > 0
               and all(abs(o - round(o / 25_000.0) * 25_000.0) < 100.0
                       for o in offsets))
    if on_grid:
        chans = [int(round(o / 25_000.0)) % n_chan for o in offsets]
        print(f"routing {len(chans)} carrier(s) through the PFB "
              f"({n_chan} channels)", file=sys.stderr)
        mrx = MultiCarrierReceiver([], fs=fs, pfb_channels=chans,
                                   n_chan=n_chan, **rx_kw)
    else:
        mrx = MultiCarrierReceiver(np.asarray(offsets, np.float32),
                                   fs=fs, **rx_kw)
    chunk = int(fs // 2)  # ~0.5 s per device dispatch
    total = int(args.secs * fs) if args.secs else None
    stats = [rx.stats for rx in mrx.carriers]
    try:
        for iq in src.stream(chunk=chunk, total_samples=total):
            stats = mrx.process_iq(iq, final=False)
        stats = mrx.process_iq(np.zeros(0, np.complex64), final=True)
    except KeyboardInterrupt:
        stats = mrx.process_iq(np.zeros(0, np.complex64), final=True)
    finally:
        src.close()
    for off, s in zip(offsets, stats):
        print(f"{off / 1e3:+9.1f} kHz: {s.bursts} bursts, "
              f"CRC ok/wrong = {s.crc_ok}/{s.crc_wrong}", file=sys.stderr)
    return mrx


def main(argv=None, log=None):
    """The CLI. log: the receivers' log (default: print for one carrier,
    none for --rtltcp's carriers, as in tetra_tpu). Returns the
    --rtltcp mode's MultiCarrierReceiver (else None)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--udp", type=int, nargs="?", const=TELIVE_PORT,
                   help=f"listen for samples on UDP port (default {TELIVE_PORT})")
    g.add_argument("--file", help="capture file (.bits/.fl/.cfile)")
    g.add_argument("--rtltcp", help="rtl_tcp server host[:port] (live SDR)")
    g.add_argument("--audio", help="fcdp audio-card I/Q: stereo PCM path "
                   "or '-' for stdin (arecord -f S16_LE -c 2 -r 96000 -t "
                   "raw | ...)")
    p.add_argument("--audio-rate", type=float, default=96_000.0,
                   help="audio sample rate (fcdp default 96000)")
    p.add_argument("--audio-fmt", default="s16le",
                   choices=("s16le", "f32le"))
    p.add_argument("--swap-iq", action="store_true",
                   help="swap the I/Q channel pairing")
    p.add_argument("--calibration", default="0",
                   help="frequency offset to translate out (the "
                   "reference's -c), or 'auto' to measure it off the "
                   "first second of samples")
    p.add_argument("--fmt", default="auto", choices=("auto", "bits", "float", "iq"))
    p.add_argument("--sps", type=int, default=2,
                   help="samples per symbol of --file/--udp IQ (angle demod)")
    p.add_argument("--freq", type=float, help="tuner centre frequency (Hz)")
    p.add_argument("--rate", type=float, default=1.8e6,
                   help="tuner sample rate (Hz)")
    p.add_argument("--gain", type=float, help="tuner gain dB (default AGC)")
    p.add_argument("--ppm", type=int, default=0)
    p.add_argument("--carriers", default="auto",
                   help="'auto' (scan) or comma list of offsets in Hz")
    p.add_argument("--secs", type=float, default=0.0,
                   help="stop after this many seconds (0 = until ^C)")
    p.add_argument("-d", dest="dumpdir")
    p.add_argument("-k", dest="keystore")
    p.add_argument("-g", dest="gsmtap", nargs="?", const="localhost")
    p.add_argument("--voice", action="store_true",
                   help="decode TCH/S traffic slots to .cod codec-frame "
                   "files in the dump dir (needs -d)")
    p.add_argument("--control-plane", default="python",
                   choices=("python", "native"),
                   help="multi-carrier control plane (--rtltcp): 'native' "
                   "routes all carriers through the C++ executor")
    p.add_argument("--soft", action="store_true",
                   help="soft-decision demod + soft Viterbi + tolerant "
                   "sync (--rtltcp, needs --control-plane native): ~2 dB "
                   "on weak signals, the counterpart of the reference's "
                   "feedback demodulator (cqpsk.py) at low SNR")
    p.add_argument("--device", default=None,
                   help="torch device for the device stages (default: "
                        "the CUDA card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    if args.rtltcp:
        return run_rtltcp(args, log=log)

    rx = TetraReceiver(keystore_path=args.keystore, dumpdir=args.dumpdir,
                       gsmtap_host=args.gsmtap, decode_voice=args.voice,
                       log=print if log is None else log, device=args.device)
    if args.audio:
        run_audio(rx, args)
    elif args.file:
        kind, data = load_capture(args.file, args.fmt)
        rx.process_bits(capture_to_bits(kind, data, sps=args.sps,
                                        device=rx.device))
    else:
        fmt = "iq" if args.fmt == "auto" else args.fmt
        run_udp(rx, args.udp, fmt, args.sps)
    s = rx.stats
    print(f"\n{s.bursts} bursts, CRC ok/wrong = {s.crc_ok}/{s.crc_wrong}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
