"""The comparison that decides `correct`: what the timed path produced
in the check pass (one more pass of the window's receiver calls, after
the window) against the plain reference worked out again from the same
capture (`portbench.reference`), and every pass of the window against
the check pass.

Numbers compared, each beside its limit (`LIMITS`, set from the
readings PERF.md lists; the exact ones have the limit 0):

- fe_rel_err: the front end's own output before the demod (the
  channels at the 36 kHz demod rate, each feed of the pass), its
  largest deviation from the float64 reference as a share of the
  reference's rms, over every carrier and feed;
- demod_rel_err: the demod's output before the slicer (each carrier's
  differential phasors at the sample phase its timing score picked,
  each feed), measured so against the float64 reference's: the matched
  filter, the phasors and the timing pick, which the decoded bits of a
  clean capture do not see;
- feeds_differing: feeds whose sample span differs from the reference's
  overlap-save geometry;
- slots_differing: emitted slots (by carrier and processed-burst index)
  whose kind, CRC flags or decoded type-1 blocks differ, or that only
  one side has, over every carrier;
- bursts_differing, cells_differing: carriers whose processed-burst
  count, or cell identity (colour code, MCC, MNC), differs;
- walk_differing: carriers of a sample drawn from the seed whose CRC-OK
  and CRC-wrong counts or TL-SDU list (protocol discriminator, PDU type,
  length, in order) differ from the reference walk's;
- passes_differing: passes of the window whose per-carrier results
  (bursts, CRC counts, cell, TL-SDU count) differ from the check pass's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import fec, frontend, sync, walk_ref

LIMITS = {"fe_rel_err": 1e-4, "demod_rel_err": 1e-4, "feeds_differing": 0, "slots_differing": 0,
          "bursts_differing": 0, "cells_differing": 0, "walk_differing": 0,
          "passes_differing": 0}
EV_TLSDU = 12                # the native walk's TL-SDU event kind


def cuts_of(cfg: dict, n_samples: int) -> list[int]:
    """Sample indices at which the configuration cuts one capture into
    its calls."""
    if "chunks_per_capture" in cfg:
        return [int(x) for x in np.linspace(
            0, n_samples, int(cfg["chunks_per_capture"]) + 1).astype(int)]
    step = int(cfg["chunk_samples"])
    return list(range(0, n_samples, step)) + [n_samples]


def reference_feeds(cfg: dict, n_samples: int) -> list[dict]:
    cuts = cuts_of(cfg, n_samples)
    if cfg["front_end"] == "pfb":
        return frontend.pfb_feeds(n_samples, cuts, int(cfg["n_chan"]),
                                  float(cfg["fs"]))
    return frontend.mixer_feeds(n_samples, cuts, float(cfg["fs"]))


def _planes(cfg, samples: torch.Tensor, f: dict, dtype):
    if cfg["format"] == "iq4c":
        return frontend.dequant_iq4c(samples[f["start"]:f["end"]], dtype)
    return frontend.u8_planes(samples[2 * f["start"]:2 * f["end"]], dtype)


def reference_channels(cfg: dict, cap: dict, samples: torch.Tensor,
                       f: dict, precision: str):
    """The reference front end over one feed: (re, im) [C, n_out]."""
    dt = torch.float64 if precision == "f64" else torch.float32
    re, im = _planes(cfg, samples, f, dt)
    if cfg["front_end"] == "pfb":
        return frontend.pfb_frontend(re, im, int(cfg["n_chan"]),
                                     float(cfg["fs"]), precision)
    return frontend.mixer_frontend(re, im, cap["offsets_hz"],
                                   float(cfg["fs"]), f["base"], precision)


def fe_error(got, want) -> float:
    """Largest |got - want| over each carrier's samples, as a share of
    that carrier's rms in `want`, the worst carrier."""
    gr, gi = (g.to(want[0].dtype) for g in got)
    d = torch.maximum((gr - want[0]).abs().amax(dim=1),
                      (gi - want[1]).abs().amax(dim=1))
    rms = torch.sqrt((want[0] ** 2 + want[1] ** 2).mean(dim=1) / 2) + 1e-30
    return float((d / rms).max())


def program_slots(collects: list, n_car: int):
    """The program's emitted slots from its collected chunks: ({carrier:
    (burst index [n], kind [n], rows [n, ROW])}, processed-burst totals
    [n_car]); a row's burst index counts every processed burst on its
    carrier up to it, its own included."""
    per = {c: ([], [], []) for c in range(n_car)}
    base = np.zeros(n_car, np.int64)
    for d in collects:
        car = np.asarray(d["carrier"], np.int64)
        delta = np.asarray(d["delta"], np.int64)
        kind = np.asarray(d["kind"], np.int64)
        rows = np.concatenate([np.asarray(d["payload"], np.uint8)[:, :406],
                               np.asarray(d["okA"], np.uint8)[:, None],
                               np.asarray(d["okB"], np.uint8)[:, None]],
                              axis=1)
        for c in np.unique(car):
            m = car == c
            idx = base[c] + np.cumsum(delta[m])
            per[c][0].append(idx)
            per[c][1].append(kind[m])
            per[c][2].append(rows[m])
            base[c] = idx[-1]
        base[np.asarray(d["side_carrier"], np.int64)] += \
            np.asarray(d["tail"], np.int64)
    out = {}
    for c, (i, k, r) in per.items():
        out[c] = ((np.concatenate(i) if i else np.zeros(0, np.int64)),
                  (np.concatenate(k) if k else np.zeros(0, np.int64)),
                  (np.concatenate(r) if r else np.zeros((0, fec.ROW),
                                                         np.uint8)))
    return out, base


def reference_run(cfg: dict, cap: dict, samples: torch.Tensor,
                  feeds: list, precision: str, fe_cb=None, dm_cb=None,
                  demod_precision: str | None = None) -> dict:
    """The reference receiver over the capture: per feed the front end
    (fe_cb(i, channels) sees each), the demod (dm_cb(i, phasors) sees
    its output before the slicer; in demod_precision, by default the
    front end's), the kept bits; then the
    synchroniser over each carrier's whole stream and the decode of its
    emitted slots. Returns {'burst', 'emit' [B, steps] (the
    synchroniser's processed-burst and emitted-slot flags), 'slots':
    {carrier: (burst index, kind, rows)}, 'bursts' [B], 'cells' [B, 3]
    (colour code, MCC, MNC of the last SYNC block that passed its CRC)}."""
    bits = []
    for i, f in enumerate(feeds):
        ch = reference_channels(cfg, cap, samples, f, precision)
        if fe_cb is not None:
            fe_cb(i, ch)
        dp = demod_precision or precision
        if dp != precision:
            ch = tuple(x.to(torch.float64 if dp == "f64" else torch.float32)
                       for x in ch)
        ph = frontend.demod_phasors(ch[0], ch[1], precision=dp)
        del ch
        if dm_cb is not None:
            dm_cb(i, ph)
        b = frontend.hard_bits(*ph)
        del ph
        if f["keep"]:
            bits.append(b[:, b.shape[1] - f["keep"]:])
    stream = torch.cat(bits, dim=1)
    st = sync.scan_stream(stream)
    burst = st["burst"].T.cpu().numpy()
    emit = st["emit"].T.cpu().numpy()
    col = st["col"].T.cpu().numpy()
    slot = st["slot"].T.cpu().numpy()
    B = stream.shape[0]
    bc = np.cumsum(burst, axis=1)
    car, step = np.nonzero(emit)
    rows = fec.decode_slots(stream, car, slot[car, step].astype(np.int64),
                            col[car, step].astype(np.int64))
    slots, cells = {}, np.zeros((B, 3), np.int64)
    for c in range(B):
        m = car == c
        slots[c] = (bc[c, step[m]], col[c, step[m]].astype(np.int64), rows[m])
        ok_sb1 = (slots[c][1] == 0) & (rows[m][:, fec.ROW - 2] == 1)
        if ok_sb1.any():
            t1 = rows[m][np.flatnonzero(ok_sb1)[-1], :60].astype(np.int64)
            u = lambda lo, n: int(t1[lo:lo + n] @ (1 << np.arange(n - 1, -1, -1)))
            cells[c] = (u(4, 6), u(31, 10), u(41, 14))
    return {"burst": burst, "emit": emit, "slots": slots,
            "bursts": bc[:, -1] if bc.shape[1] else np.zeros(B, np.int64),
            "cells": cells}


def slots_differing(prog: dict, ref: dict) -> int:
    """Slots that differ or that one side alone has, over all carriers."""
    n = 0
    for c, (pi, pk, pr) in prog.items():
        ri, rk, rr = ref[c]
        pmap = {int(i): (int(k), r) for i, k, r in zip(pi, pk, pr)}
        rmap = {int(i): (int(k), r) for i, k, r in zip(ri, rk, rr)}
        for i in set(pmap) | set(rmap):
            a, b = pmap.get(i), rmap.get(i)
            if a is None or b is None or a[0] != b[0] \
                    or not np.array_equal(a[1], b[1]):
                n += 1
    return n


def pass_summary(carriers, native_events) -> np.ndarray:
    """Per-carrier results of one pass [B, 7]: bursts, CRC-OK,
    CRC-wrong, colour code, MCC, MNC, TL-SDUs."""
    B = len(carriers)
    tl = np.zeros(B, np.int64)
    for e in native_events:
        m = e["kind"] == EV_TLSDU
        tl += np.bincount(e["carrier"][m], minlength=B)
    st = np.asarray([(c.stats.bursts, c.stats.crc_ok, c.stats.crc_wrong,
                      c.colour_code, c.mcc, c.mnc) for c in carriers],
                    np.int64).reshape(B, 6)
    return np.column_stack([st, tl])


def program_tl_sdus(native_events, carrier: int) -> list:
    out = []
    for e in native_events:
        m = (e["kind"] == EV_TLSDU) & (e["carrier"] == carrier)
        out += [(int(a), int(b), int(c)) for a, b, c in
                zip(e["a"][m], e["b"][m], e["c"][m])]
    return out


def walk_sample(cfg: dict, cap: dict, seed: int) -> np.ndarray:
    """The carriers whose walk the reference repeats: all of them up to
    `check_walk_carriers`, else that many drawn from the seed, half of
    them (or all there are) from the encrypted ones."""
    n_car = int(cfg["carriers"])
    k = int(cfg["check_walk_carriers"])
    if k >= n_car:
        return np.arange(n_car)
    rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    enc = np.flatnonzero(cap["encrypted"].cpu().numpy())
    plain = np.setdiff1d(np.arange(n_car), enc)
    ne = min(len(enc), k // 2)
    pick = np.concatenate([rng.choice(enc, ne, replace=False),
                           rng.choice(plain, k - ne, replace=False)])
    return np.sort(pick)


def evaluate(cfg: dict, cap: dict, record: dict, summaries: list,
             seed: int, ks_path: str | None, device,
             precision: str = "f64") -> tuple[dict, dict]:
    """Every number compared, from the program's check pass (`record`:
    'fe' [(n_in, base, (re, im))] a front-end call, 'dm' [(sr, si)] a
    demod call, 'collects' the collected chunk dicts, 'carriers',
    'native_events') and the window's per-pass summaries. Returns
    ({name: value}, {what was compared: how many})."""
    dev = torch.device(device)
    samples = torch.as_tensor(cap["samples_host"]).to(dev)
    n_samples = len(cap["samples_host"]) // (2 if cfg["format"] == "u8" else 1)
    feeds = reference_feeds(cfg, n_samples)
    fe_calls = record["fe"]
    res = {"feeds_differing": abs(len(fe_calls) - len(feeds))}
    for f, call in zip(feeds, fe_calls):
        base = f["base"] if cfg["front_end"] == "mixer" else None
        res["feeds_differing"] += (call[0], call[1]) != (f["end"] - f["start"],
                                                         base)
    dm_calls = record["dm"]
    res["feeds_differing"] += abs(len(dm_calls) - len(feeds))
    worst = {"fe": 0.0, "dm": 0.0}

    def held(key, got):
        def cb(i, want):
            if i < len(got) and got[i][0].shape == want[0].shape:
                worst[key] = max(worst[key], fe_error(got[i], want))
            else:
                worst[key] = math.inf
        return cb

    ref = reference_run(cfg, cap, samples, feeds, precision,
                        held("fe", [c[2] for c in fe_calls]),
                        held("dm", dm_calls))
    res["fe_rel_err"], res["demod_rel_err"] = worst["fe"], worst["dm"]
    n_car = int(cfg["carriers"])
    prog, prog_bursts = program_slots(record["collects"], n_car)
    res["slots_differing"] = slots_differing(prog, ref["slots"])
    last = pass_summary(record["carriers"], record["native_events"])
    res["bursts_differing"] = int((last[:, 0] != ref["bursts"]).sum()
                                  + (prog_bursts != ref["bursts"]).sum())
    res["cells_differing"] = int((last[:, 3:6] != ref["cells"]).any(1).sum())
    n_walk, n_sdus = 0, 0
    sample = walk_sample(cfg, cap, seed)
    for c in sample:
        w = walk_ref.walk_carrier(ref["burst"][c], ref["emit"][c],
                                  ref["slots"][c][2], ref["slots"][c][1],
                                  ks_path)
        got = (int(last[c, 1]), int(last[c, 2]),
               program_tl_sdus(record["native_events"], c))
        n_walk += got != (w["crc_ok"], w["crc_wrong"], w["tl_sdus"])
        n_sdus += len(w["tl_sdus"])
    res["walk_differing"] = n_walk
    res["passes_differing"] = sum(not np.array_equal(s, last)
                                  for s in summaries)
    compared = {"feeds": len(feeds),
                "slots": sum(len(v[0]) for v in ref["slots"].values()),
                "carriers": n_car, "walk_carriers": len(sample),
                "walk_tl_sdus": n_sdus, "passes": len(summaries),
                "crc_ok": int(last[:, 1].sum()),
                "crc_wrong": int(last[:, 2].sum()),
                "tl_sdus": int(last[:, 6].sum())}
    return res, compared


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
