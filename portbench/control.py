"""Readings that set the comparison's limits (check.LIMITS), at a cell's
own size on the card: for each seed, the program's numbers after one
warm pass, `--programs` window passes and the check pass (the lower
readings), and the control's: the plain reference put in the program's
place and computed one precision below the configuration's, against the
float64 reference (the upper readings). The port computes float32 with
TF32 off, so the control is the reference in TF32: float32 with every
operand of a multiply rounded to TF32's 10-bit mantissa
(reference/frontend.py). It is read twice: over the whole chain (front
end, demod and the cell's slicer, its decisions held as the program's
are), and over the demod alone, on the float64 reference's channels. The benchmark's runs never
run this.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \\
        [--programs 1] [--control 1]

Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import capture, check, registry, run
from portbench.reference import frontend


def readings(workload: str, seed: int, programs: int = 1,
             control: bool = True, device: str = "cuda") -> dict:
    bench = registry.load_benchmark(run.ROOT)
    w = registry.cell(bench, workload)
    cfg = registry.load_config(run.ROOT, w["config_entry"])
    mix = registry.load_traffic(w["traffic"])
    dev = torch.device(device)
    cap = capture.make_capture(cfg, mix, seed, dev)
    cap["samples_host"] = cap["samples"].cpu().numpy()
    out = {"workload": workload, "seed": seed}
    if programs:
        with run.keystore(cfg) as ks:
            cell = run.Cell(cfg, cap, ks, dev)
            cell.one_pass()
            summaries = []
            for _ in range(programs):
                summaries.append(run.summarised(cell.one_pass()))
            record = run.recorded_pass(cell)
            out["program"], out["compared"] = check.evaluate(
                cfg, cap, record, summaries, seed, ks, dev)
            del record
    if not control:
        return out
    samples = cap["samples"]
    n = len(cap["samples_host"]) // (2 if cfg["format"] == "u8" else 1)
    feeds = check.reference_feeds(cfg, n)
    ctl_ch, ctl_ph, ctl_dec = {}, {}, {}
    worst = {"fe": 0.0, "dm": 0.0, "dm_only": 0.0}
    ctl = check.reference_run(cfg, cap, samples, feeds, "tf32",
                              lambda i, ch: ctl_ch.__setitem__(i, ch),
                              lambda i, ph: ctl_ph.__setitem__(i, ph),
                              dec_cb=lambda i, d: ctl_dec.__setitem__(i, d))

    def f64_channels(i, ch):
        worst["fe"] = max(worst["fe"], check.fe_error(ctl_ch.pop(i), ch))
        *lo, _ = frontend.demod_phasors(*(x.float() for x in ch),
                                        precision="tf32")
        *hi, _ = frontend.demod_phasors(*ch, precision="f64", near=lo)
        worst["dm_only"] = max(worst["dm_only"], check.fe_error(lo, hi))

    def f64_phasors(i, ph):
        worst["dm"] = max(worst["dm"], check.fe_error(ctl_ph[i], ph))

    # the float64 reference with the control in the program's place: its
    # timing picks and slicer decisions held and followed on ties as the
    # check holds and follows the program's
    ref = check.reference_run(
        cfg, cap, samples, feeds, "f64", f64_channels, f64_phasors,
        program_phasors=[ctl_ph[i] for i in range(len(feeds))],
        program_decisions=[ctl_dec[i] for i in range(len(feeds))])
    out["control"] = {"fe_rel_err": worst["fe"], "demod_rel_err": worst["dm"],
                      "demod_rel_err.demod_alone": worst["dm_only"],
                      "decisions_far": ref["decisions_far"],
                      "decision_ties": ref["decision_ties"],
                      "decisions": ref["decisions"],
                      "slots_differing": check.slots_differing(
                          ctl["slots"], ref["slots"])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--programs", type=int, default=1)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    run.set_cache_dirs(run.ROOT)
    from tetra_tpu_torch import kernels
    kernels.lib()
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.programs,
                                  bool(args.control))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
