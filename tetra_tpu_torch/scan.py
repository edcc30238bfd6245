"""Spectrum scan: find and confirm TETRA carriers in a wideband capture
(port of tetra_tpu.scan).

Reference behaviour: the live demod GUIs draw an FFT plot and the user
*clicks* on a carrier to tune it (reference
src/demod/osmosdr-tetra_demod_fft.py:102-130 `on_fft_plot_click` sets
the xlating-filter centre frequency). Here the click is replaced by
measurement: the capture's power spectrum (a batched FFT on the device)
is folded onto the 25 kHz TETRA channel raster (reference
src/tetra_common.c:56 carrier spacing) on the host, channels above the
noise floor become candidates, and each candidate is *confirmed* by
running the receive chain on it (burst lock + BSCH decode ->
MCC/MNC/colour code), all candidates through one mixer-bank
MultiCarrierReceiver. The output feeds the multi-carrier receiver
(`python -m tetra_tpu_torch.receiver --rtltcp ... --carriers auto`).

Usage:
  python -m tetra_tpu_torch.scan capture.cfile --fs 1800000 [--device cpu]
  python -m tetra_tpu_torch.scan --rtltcp host[:port] --freq 392.5e6 --rate 1.8e6
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tetra_tpu_torch.device import resolve_device

__all__ = ["power_spectrum", "channel_power", "detect_carriers",
           "confirm_carriers", "scan", "render_spectrum"]

CHANNEL_SPACING = 25_000.0


def power_spectrum(iq, fs: float, nfft: int = 4096, device=None):
    """Welch-averaged power spectrum. Returns (freqs [nfft], psd_db
    [nfft] float32) with freqs ascending (fftshifted), relative to the
    capture centre. One batched complex64 FFT on `device` (the card
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    iq = np.asarray(iq)
    n_seg = max(len(iq) // nfft, 1)
    if len(iq) < nfft:
        iq = np.pad(iq, (0, nfft - len(iq)))
    segs = torch.as_tensor(np.ascontiguousarray(
        iq[: n_seg * nfft].reshape(n_seg, nfft), np.complex64), device=dev)
    win = torch.as_tensor(np.hanning(nfft).astype(np.float32), device=dev)
    spec = torch.fft.fft(segs * win, dim=-1)
    psd = torch.mean(spec.abs() ** 2, dim=0)
    psd = torch.fft.fftshift(psd) / (torch.sum(win ** 2) * fs)
    freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / fs))
    psd_db = 10.0 * torch.log10(torch.clamp(psd, min=1e-30))
    return freqs, psd_db.cpu().numpy()


def channel_power(freqs, psd_db, fs: float,
                  spacing: float = CHANNEL_SPACING, occ_bw: float = 18_000.0):
    """Fold a PSD onto the channel raster: mean in-band power per
    channel centre (multiples of `spacing` inside ±(fs/2 − spacing)).
    Returns (centers_hz [C], power_db [C])."""
    half = fs / 2.0 - spacing
    k_max = int(half // spacing)
    centers = np.arange(-k_max, k_max + 1) * spacing
    power = np.empty(len(centers), np.float64)
    lin = 10.0 ** (np.asarray(psd_db) / 10.0)
    for i, c in enumerate(centers):
        m = np.abs(freqs - c) <= occ_bw / 2.0
        power[i] = 10.0 * np.log10(max(lin[m].mean(), 1e-30))
    return centers, power


def detect_carriers(iq, fs: float, thresh_db: float = 8.0,
                    nfft: int = 4096, device=None):
    """Channels whose in-band power exceeds the noise floor (median
    channel power) by thresh_db. Returns (offsets_hz [K], snr_db [K],
    (centers, power_db, floor) for plotting).

    Narrow captures (audio-rate fcdp: fewer than 3 raster channels fit)
    fall back to a PSD-peak offset estimate — the measured equivalent
    of reading the calibration offset off the reference's FFT plot
    (fcdp-tetra_demod_fft.py) — so one candidate at the estimated
    offset is returned for decode confirmation."""
    freqs, psd_db = power_spectrum(iq, fs, nfft, device)
    centers, power = channel_power(freqs, psd_db, fs)
    if len(centers) < 3:
        floor = float(np.median(psd_db))
        # in-band PSD centroid around the strongest bin (±9 kHz = half
        # the occupied bandwidth), rounded to 100 Hz
        usable = np.abs(freqs) <= fs / 2.0 - 9_000.0
        pk = np.flatnonzero(usable)[np.argmax(psd_db[usable])]
        # the peak bin of a (flat-topped) DQPSK spectrum can sit at the
        # band edge; iterate the in-band centroid, re-centering the
        # ±9 kHz window, until it settles on the true carrier centre
        est = float(freqs[pk])
        for _ in range(4):
            m = np.abs(freqs - est) <= 9_000.0
            lin = 10.0 ** (psd_db[m] / 10.0)
            est = float((freqs[m] * lin).sum() / lin.sum())
        off = round(est / 100.0) * 100.0
        snr1 = float(psd_db[pk] - floor)
        if snr1 >= thresh_db:
            return (np.asarray([off]), np.asarray([snr1]),
                    (centers, power, float(np.median(power))))
        return (np.zeros(0), np.zeros(0),
                (centers, power, float(np.median(power))))
    floor = np.median(power)
    snr = power - floor
    hot = snr >= thresh_db
    # non-maximum suppression: spectral leakage can push a neighbour of
    # a strong carrier over the threshold; keep local maxima only
    keep = hot.copy()
    for i in np.flatnonzero(hot):
        lo, hi = max(i - 1, 0), min(i + 2, len(power))
        if power[i] < power[lo:hi].max():
            keep[i] = False
    return centers[keep], snr[keep], (centers, power, floor)


def confirm_carriers(iq, fs: float, offsets_hz, max_seconds: float = 2.0,
                     device=None):
    """Run the receive chain on each candidate (one mixer-bank receiver,
    Python plane): burst lock + full FEC + BSCH decode. Returns a list
    of dicts with offset/bursts/crc_ok and the decoded cell identity
    when a SYNC burst was CRC-clean."""
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    iq = np.asarray(iq)[: int(max_seconds * fs)]
    offsets = np.asarray(offsets_hz, np.float32)
    if len(offsets) == 0:
        return []
    mrx = MultiCarrierReceiver(offsets, fs=fs, device=device)
    stats = mrx.process_iq(iq)
    out = []
    for off, rx, s in zip(offsets, mrx.carriers, stats):
        out.append(dict(offset_hz=float(off), bursts=s.bursts,
                        crc_ok=s.crc_ok, crc_wrong=s.crc_wrong,
                        mcc=rx.mcc, mnc=rx.mnc, colour_code=rx.colour_code,
                        confirmed=bool(s.crc_ok > 0 and rx.mcc is not None)))
    return out


def scan(iq, fs: float, thresh_db: float = 8.0, confirm: bool = True,
         device=None):
    """detect + (optionally) confirm. Returns (results, plotdata)."""
    offsets, snr, plotdata = detect_carriers(iq, fs, thresh_db,
                                             device=device)
    if confirm:
        results = confirm_carriers(iq, fs, offsets, device=device)
        for r, s in zip(results, snr):
            r["snr_db"] = float(s)
    else:
        results = [dict(offset_hz=float(o), snr_db=float(s), confirmed=None)
                   for o, s in zip(offsets, snr)]
    return results, plotdata


def render_spectrum(centers, power_db, floor_db, width: int = 64,
                    marks=()) -> str:
    """ASCII channel-power plot (the FFT display, one row per channel)."""
    lo = floor_db - 3.0
    hi = max(power_db.max(), lo + 1.0)
    lines = []
    markset = {round(m / CHANNEL_SPACING) for m in marks}
    for c, p in zip(centers, power_db):
        n = int(np.clip((p - lo) / (hi - lo), 0.0, 1.0) * width)
        tag = " <== carrier" if round(c / CHANNEL_SPACING) in markset else ""
        lines.append(f"{c / 1e3:+9.1f} kHz |{'#' * n:<{width}}| "
                     f"{p:6.1f} dB{tag}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("capture", nargs="?", help="complex64 cfile")
    p.add_argument("--fs", type=float, help="capture sample rate (Hz)")
    p.add_argument("--rtltcp", help="rtl_tcp server host[:port]")
    p.add_argument("--audio", help="fcdp audio-card I/Q: stereo PCM path "
                   "or '-' (the fcdp-tetra_demod_fft.py spectrum analogue)")
    p.add_argument("--audio-rate", type=float, default=96_000.0)
    p.add_argument("--audio-fmt", default="s16le",
                   choices=("s16le", "f32le"))
    p.add_argument("--freq", type=float, help="tuner centre frequency (Hz)")
    p.add_argument("--rate", type=float, default=1.8e6,
                   help="tuner sample rate (Hz; reference default 1.8 Msps)")
    p.add_argument("--gain", type=float, help="tuner gain dB (default AGC)")
    p.add_argument("--ppm", type=int, default=0)
    p.add_argument("--secs", type=float, default=2.0,
                   help="capture length to analyse")
    p.add_argument("--thresh", type=float, default=8.0,
                   help="detection threshold over noise floor (dB)")
    p.add_argument("--no-confirm", action="store_true",
                   help="power detection only (skip decode confirmation)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain versions)")
    args = p.parse_args(argv)

    if args.rtltcp:
        from tetra_tpu_torch.io.sdr import RtlTcpSource, RTL_TCP_PORT
        host, _, port = args.rtltcp.partition(":")
        src = RtlTcpSource(host, int(port) if port else RTL_TCP_PORT)
        print(f"rtl_tcp: tuner {src.tuner_name}, "
              f"{src.tuner_gain_count} gain steps", file=sys.stderr)
        src.configure(freq_hz=args.freq or 0.0, rate_hz=args.rate,
                      gain_db=args.gain, ppm=args.ppm)
        fs = args.rate
        iq = src.read(int(args.secs * fs))
        src.close()
    elif args.audio:
        from tetra_tpu_torch.io.audio import AudioPipeSource
        src = AudioPipeSource(args.audio, sample_rate=args.audio_rate,
                              fmt=args.audio_fmt)
        fs = args.audio_rate
        iq = src.read(int(args.secs * fs))
        src.close()
    else:
        if not args.capture or not args.fs:
            p.error("need a capture file + --fs, or --rtltcp")
        fs = args.fs
        iq = np.fromfile(args.capture, dtype=np.complex64,
                         count=int(args.secs * fs))

    results, (centers, power, floor) = scan(iq, fs, args.thresh,
                                            confirm=not args.no_confirm,
                                            device=args.device)
    marks = [r["offset_hz"] for r in results
             if r.get("confirmed") is not False]
    print(render_spectrum(centers, power, floor, marks=marks))
    print(f"\nnoise floor {floor:.1f} dB; {len(results)} candidate(s):")
    for r in results:
        line = f"  {r['offset_hz'] / 1e3:+9.1f} kHz  snr {r.get('snr_db', 0.0):5.1f} dB"
        if r.get("confirmed"):
            line += (f"  CONFIRMED TETRA  mcc={r['mcc']} mnc={r['mnc']} "
                     f"cc={r['colour_code']} crc_ok={r['crc_ok']}")
        elif r.get("confirmed") is False:
            line += f"  unconfirmed ({r['bursts']} bursts, {r['crc_ok']} ok)"
        print(line)
    if results:
        offs = ",".join(str(int(r["offset_hz"])) for r in results
                        if r.get("confirmed") is not False)
        print(f"\ntune: --carriers {offs}")
    return results


if __name__ == "__main__":
    main()
