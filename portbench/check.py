"""The comparison that decides `correct`: what the timed path produced
in the check pass (one more pass of the window's receiver calls, after
the window) against the plain reference worked out again from the same
capture (`portbench.reference`), and every pass of the window against
the check pass.

The reference slices as the receiver does, hard or soft by the
configuration's `demod`, with the sync at the receiver's tolerance (2 on
a soft pipeline, 0 else). The program's slicer output is compared with
the reference's decision by decision. A decision may differ only where
the reference's value lies so near a slicer threshold that the
program's phasors, as far as they lie from the reference's on that
carrier in that feed, could fall on its other side (a tie: a hard bit
whose phasor component lies within that distance of zero, a soft value
one step off whose scaled value lies within its reach of the half step
between the two); every other difference is a fault of the slicer
(decisions_far). The sync, FEC and walk then run on the reference's
decisions with the program's taken at the ties, so that a rounding tie
on a noisy capture cannot reach a CRC while a fault in any of those
stages still shows in the exact counts.

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
- decisions_far: the slicer's hard bits or soft values (each feed,
  every carrier) that differ from the float64 reference's where no tie
  explains it (above);
- feeds_differing: feeds whose sample span differs from the reference's
  overlap-save geometry;
- slots_differing: emitted slots (by carrier and processed-burst index)
  whose kind, CRC flags or decoded type-1 blocks differ, or that only
  one side has, over every carrier;
- bursts_differing, cells_differing: carriers whose processed-burst
  count, or cell identity (colour code, MCC, MNC), differs;
- walk_differing: carriers of a sample drawn from the seed among those
  on air, whose CRC-OK and CRC-wrong counts or TL-SDU list (protocol
  discriminator, PDU type, length, in order) differ from the reference
  walk's;
- passes_differing: passes of the window whose per-carrier results
  (bursts, CRC counts, cell, TL-SDU count; with egress also the blocks,
  voice frames, bytes and files of each carrier's dump directory, by
  its listing after the pass) differ from the check pass's.

On a configuration with `egress` (egress.py) two more, both exact:

- dumps_differing: the check pass's dump blocks (`.out`) and `.txt`
  lines that differ from the reference's (`reference/voice.py` over the
  reference's own descrambled type-4 bits of each traffic slot that the
  reference walk dumps, on every carrier), by file (usage and timeslot)
  and in slot order, or that one side alone has;
- voice_differing: the same of the `.cod` voice frames (the TCH/S
  decode, the codec order, the voice keystream of a TEA1 slot, which
  the reference walk makes), on every carrier.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import egress
from portbench.reference import fec, frontend, sync, walk_ref

LIMITS = {"fe_rel_err": 1e-4, "demod_rel_err": 1e-4, "decisions_far": 0,
          "feeds_differing": 0, "slots_differing": 0, "bursts_differing": 0,
          "cells_differing": 0, "walk_differing": 0, "passes_differing": 0,
          "dumps_differing": 0, "voice_differing": 0}
# compared only on a configuration with `egress`
EGRESS_NUMBERS = ("dumps_differing", "voice_differing")
# float32's own rounding in the soft slicer (the mean magnitude, the
# division, the scale by 31) as a share of the scaled value, with room:
# it is of the order of 1e-7 (a few ulps)
SOFT_SLACK = 2.0 ** -16
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


def slicer(cfg: dict) -> str:
    """The receiver's slicer, "hard" or "soft" (the configuration's
    `demod`; the mixer bank slices hard whatever it is, and the check
    does not follow that case)."""
    if cfg["demod"] == "soft" and cfg["front_end"] != "pfb":
        raise ValueError("the check follows a soft receiver on the "
                         "filterbank only")
    return cfg["demod"]


def decision_ties(ref_ph: tuple, prog_ph: tuple, want: torch.Tensor,
                  got: torch.Tensor, kind: str) -> tuple:
    """The program's slicer output `got` against the reference's `want`
    [C, 2n] (hard bits or soft values, each sliced from its own demod
    output: ref_ph the reference's (sr, si) [C, n], prog_ph the
    program's). Returns (far, tie), bool [C, 2n]. With dev the largest
    distance of a component of the program's phasors from the
    reference's on that carrier, a hard bit is a tie where its
    component lies within dev of zero; a soft value one step off is a
    tie where the reference's scaled value lies within its reach of the
    half step between the two: 31 dev (1 + sqrt2 |x| / nrm) / (nrm -
    sqrt2 dev), as far as dev can move x / nrm (the mean magnitude nrm
    moves by at most sqrt2 dev), plus float32's own rounding
    (SOFT_SLACK). far: every other decision that differs."""
    rr, ri = ref_ph
    pr, pi = (x.to(rr.device, rr.dtype) for x in prog_ph)
    dev = torch.maximum((pr - rr).abs().amax(dim=1),
                        (pi - ri).abs().amax(dim=1))[:, None]
    comp = torch.stack([ri, rr], dim=-1).reshape(rr.shape[0], -1)
    diff = got.to(want.device, torch.int16) - want.to(torch.int16)
    if kind == "hard":
        tie = (diff != 0) & (comp.abs() <= dev)
    else:
        nrm = torch.sqrt(rr * rr + ri * ri).mean(dim=-1, keepdim=True) + 1e-9
        y = torch.clamp(comp / nrm, -4.0, 4.0) * 31.0
        reach = 31.0 * dev * (1 + math.sqrt(2) * comp.abs() / nrm) \
            / (nrm - math.sqrt(2) * dev).clamp_min(1e-30) \
            + SOFT_SLACK * (y.abs() + 1)
        half = (want.to(y.dtype) + got.to(want.device, y.dtype)) / 2
        tie = (diff.abs() == 1) & ((y - half).abs() <= reach)
    return (diff != 0) & ~tie, tie


def _feed_of(outputs: list | None, i: int, shape: tuple):
    """outputs[i] (a tensor, or a tuple of them) where it is there and
    of `shape`, else None."""
    if outputs is None or i >= len(outputs):
        return None
    out = outputs[i]
    first = out[0] if isinstance(out, tuple) else out
    return out if tuple(first.shape) == tuple(shape) else None


def reference_run(cfg: dict, cap: dict, samples: torch.Tensor,
                  feeds: list, precision: str, fe_cb=None, dm_cb=None,
                  demod_precision: str | None = None, dec_cb=None,
                  program_phasors: list | None = None,
                  program_decisions: list | None = None) -> dict:
    """The reference receiver over the capture: per feed the front end
    (fe_cb(i, channels) sees each), the demod (dm_cb(i, phasors) sees
    its output before the slicer; in demod_precision, by default the
    front end's; a timing pick tied to rounding follows
    program_phasors' of that feed), the slicer (dec_cb(i, decisions)
    sees its output) and the kept decisions; where program_decisions
    is given, each feed's are held to the reference's (decision_ties)
    and taken at the ties. Then the synchroniser over each carrier's
    whole stream and the decode of its emitted slots (`chain`), with
    'timing_ties' (the carrier-feeds whose pick followed the program's
    on a tie), 'timing_tie_gap' (the largest score gap of those), and
    'decisions', 'decisions_far' and 'decision_ties' (the decisions
    compared, those that differ untied, inf where a feed's are missing
    or of another shape, and those taken from the program on a tie)."""
    kind = slicer(cfg)
    kept, gaps = [], []
    dec = {"decisions": 0, "decisions_far": 0, "decision_ties": 0}
    for i, f in enumerate(feeds):
        ch = reference_channels(cfg, cap, samples, f, precision)
        if fe_cb is not None:
            fe_cb(i, ch)
        dp = demod_precision or precision
        if dp != precision:
            ch = tuple(x.to(torch.float64 if dp == "f64" else torch.float32)
                       for x in ch)
        near = _feed_of(program_phasors, i,
                        (ch[0].shape[0], ch[0].shape[1] // 2))
        sr, si, g = frontend.demod_phasors(ch[0], ch[1], precision=dp,
                                           near=near)
        ph = (sr, si)
        gaps.append(g)
        del sr, si
        del ch
        if dm_cb is not None:
            dm_cb(i, ph)
        d = frontend.decisions(*ph, kind)
        if dec_cb is not None:
            dec_cb(i, d)
        if program_decisions is not None:
            dec["decisions"] += d.numel()
            prog = _feed_of(program_decisions, i, d.shape)
            if prog is None or near is None:
                dec["decisions_far"] = math.inf
            else:
                far, tie = decision_ties(ph, near, d, prog, kind)
                dec["decisions_far"] += int(far.sum())
                dec["decision_ties"] += int(tie.sum())
                d = torch.where(tie, prog.to(d.device, d.dtype), d)
        del ph
        if f["keep"]:
            kept.append(d[:, d.shape[1] - f["keep"]:])
    gaps = torch.cat(gaps)
    return {**chain(cfg, torch.cat(kept, dim=1)), **dec,
            "timing_ties": len(gaps),
            "timing_tie_gap": float(gaps.max()) if len(gaps) else 0.0}


def chain(cfg: dict, stream: torch.Tensor) -> dict:
    """Sync, FEC and cells over each carrier's whole stream of decisions
    [B, T] (the slicer's). Returns {'burst', 'emit' [B, steps] (the
    synchroniser's processed-burst and emitted-slot flags), 'slots':
    {carrier: (burst index, kind, rows)}, 'slot_pos': {carrier: stream
    offsets of those slots}, 'stream' (the hard bits [B, T]), 'bursts'
    [B], 'cells' [B, 3] (colour code, MCC, MNC of the last SYNC block
    that passed its CRC)}."""
    soft = None
    if slicer(cfg) == "soft":
        soft, stream = stream, (stream < 0).to(torch.int8)
    st = sync.scan_stream(stream, tol=2 if soft is not None else 0)
    burst = st["burst"].T.cpu().numpy()
    emit = st["emit"].T.cpu().numpy()
    col = st["col"].T.cpu().numpy()
    slot = st["slot"].T.cpu().numpy()
    B = stream.shape[0]
    bc = np.cumsum(burst, axis=1)
    car, step = np.nonzero(emit)
    rows = fec.decode_slots(stream, car, slot[car, step].astype(np.int64),
                            col[car, step].astype(np.int64), soft)
    slots, pos, cells = {}, {}, np.zeros((B, 3), np.int64)
    for c in range(B):
        m = car == c
        slots[c] = (bc[c, step[m]], col[c, step[m]].astype(np.int64), rows[m])
        pos[c] = slot[c, step[m]].astype(np.int64)
        ok_sb1 = (slots[c][1] == 0) & (rows[m][:, fec.ROW - 2] == 1)
        if ok_sb1.any():
            t1 = rows[m][np.flatnonzero(ok_sb1)[-1], :60].astype(np.int64)
            u = lambda lo, n: int(t1[lo:lo + n] @ (1 << np.arange(n - 1, -1, -1)))
            cells[c] = (u(4, 6), u(31, 10), u(41, 14))
    return {"burst": burst, "emit": emit, "slots": slots, "slot_pos": pos,
            "stream": stream,
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
    """The carriers whose walk the reference repeats, all on air: all of
    them up to `check_walk_carriers`, else that many drawn from the
    seed, half of them (or all there are) from the encrypted ones."""
    on = np.flatnonzero(cap["on_air"].cpu().numpy())
    k = int(cfg["check_walk_carriers"])
    if k >= len(on):
        return on
    rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    enc = np.flatnonzero(cap["encrypted"].cpu().numpy())
    plain = np.setdiff1d(on, enc)
    ne = min(len(enc), k // 2)
    pick = np.concatenate([rng.choice(enc, ne, replace=False),
                           rng.choice(plain, k - ne, replace=False)])
    return np.sort(pick)


def evaluate(cfg: dict, cap: dict, record: dict, summaries: list,
             seed: int, ks_path: str | None, device,
             precision: str = "f64") -> tuple[dict, dict]:
    """Every number compared, from the program's check pass (`record`:
    'fe' [(n_in, base, (re, im))] a front-end call, 'dm' [(sr, si)] a
    demod call, 'dec' [decisions] a slicer call, 'collects' the
    collected chunk dicts, 'carriers', 'native_events') and the window's
    per-pass summaries. Returns ({name: value}, {what was compared: how
    many})."""
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
    dm_calls, dec_calls = record["dm"], record["dec"]
    res["feeds_differing"] += abs(len(dm_calls) - len(feeds)) \
        + abs(len(dec_calls) - len(feeds))
    worst = {"fe": 0.0, "dm": 0.0}

    def held(key, got):
        def cb(i, want):
            if i < len(got) and got[i][0].shape == want[0].shape:
                worst[key] = max(worst[key], fe_error(got[i], want))
            else:
                worst[key] = math.inf
        return cb

    ref = reference_run(
        cfg, cap, samples, feeds, precision,
        held("fe", [c[2] for c in fe_calls]), held("dm", dm_calls),
        program_phasors=dm_calls, program_decisions=dec_calls)
    res["fe_rel_err"], res["demod_rel_err"] = worst["fe"], worst["dm"]
    res["decisions_far"] = ref["decisions_far"]
    n_car = int(cfg["carriers"])
    prog, prog_bursts = program_slots(record["collects"], n_car)
    res["slots_differing"] = slots_differing(prog, ref["slots"])
    last = pass_summary(record["carriers"], record["native_events"])
    res["bursts_differing"] = int((last[:, 0] != ref["bursts"]).sum()
                                  + (prog_bursts != ref["bursts"]).sum())
    res["cells_differing"] = int((last[:, 3:6] != ref["cells"]).any(1).sum())
    n_walk, n_sdus = 0, 0
    sample = walk_sample(cfg, cap, seed)
    eg = egress.enabled(cfg)
    walks = {}
    for c in sample:
        w = walk_ref.walk_carrier(ref["burst"][c], ref["emit"][c],
                                  ref["slots"][c][2], ref["slots"][c][1],
                                  ks_path, traffic=eg)
        walks[int(c)] = w
        got = (int(last[c, 1]), int(last[c, 2]),
               program_tl_sdus(record["native_events"], c))
        n_walk += got != (w["crc_ok"], w["crc_wrong"], w["tl_sdus"])
        n_sdus += len(w["tl_sdus"])
    res["walk_differing"] = n_walk
    whole = last
    if eg:
        whole = np.concatenate([last.ravel(), record["egress"].ravel()])
        numbers, eg_compared = egress.evaluate(ref, record["egress_files"],
                                               walks, ks_path, n_car)
        res.update(numbers)
    res["passes_differing"] = sum(not np.array_equal(s, whole)
                                  for s in summaries)
    compared = {"feeds": len(feeds),
                "slots": sum(len(v[0]) for v in ref["slots"].values()),
                "carriers": n_car,
                "on_air": int(cap["on_air"].sum()),
                "decisions": ref["decisions"],
                "decision_ties": ref["decision_ties"],
                "timing_ties": ref["timing_ties"],
                "timing_tie_gap": ref["timing_tie_gap"],
                "walk_carriers": len(sample),
                "walk_tl_sdus": n_sdus, "passes": len(summaries),
                "crc_ok": int(last[:, 1].sum()),
                "crc_wrong": int(last[:, 2].sum()),
                "tl_sdus": int(last[:, 6].sum())}
    if eg:
        compared.update(eg_compared)
    return res, compared


def limits(cfg: dict) -> dict:
    """The numbers a configuration's check compares, with their limits:
    LIMITS, the egress numbers only where it has `egress`."""
    if egress.enabled(cfg):
        return dict(LIMITS)
    return {k: v for k, v in LIMITS.items() if k not in EGRESS_NUMBERS}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
