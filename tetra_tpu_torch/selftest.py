"""Self-test CLI, the conv_enc_test analogue (port of tetra_tpu.selftest).

Reference behaviour: src/conv_enc_test.c — the puncture/depuncture
self-test over all 9 channel configurations (tetra_conv_enc.c:250-348),
then a soak of the full encode -> decode chain with randomized PDUs and
the total CRC error count. The soak decodes through
lmac.pipeline.decode_schf_burst (kernel K1 on the card).

    python3 -m tetra_tpu_torch.selftest [--device cpu]

prints the JAX CLI's lines and exits 0 when everything passes, 1
otherwise. `--device` defaults to the card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tetra_tpu_torch import tx
from tetra_tpu_torch.device import resolve_device
from tetra_tpu_torch.lmac import pipeline
from tetra_tpu_torch.ops import rcpc
from tetra_tpu_torch.ops.scramble import scramb_get_init
from tetra_tpu_torch.phy import burst as burst_mod

__all__ = ["PUNCT_CONFIGS", "punct_test", "loopback_soak", "main"]

# the reference's 9 test configurations (tetra_conv_enc.c:253-263)
PUNCT_CONFIGS = [
    ("2_3", 80, 120, 4),       # BSCH
    ("292_432", 292, 432, 4),  # TCH/4.8
    ("148_432", 148, 432, 4),  # TCH/2.4
    ("2_3", 144, 216, 4),      # SCH/HD, BNCH, STCH
    ("2_3", 112, 168, 4),      # SCH/HU
    ("2_3", 288, 432, 4),      # SCH/F
    ("112_168", 112, 168, 3),  # speech class 1
    ("72_162", 72, 162, 3),    # speech class 2
    ("38_80", 38, 80, 3),      # speech class 2 in STCH
]


def punct_test(device=None) -> int:
    """Puncture -> depuncture must reproduce exactly the punctured mother
    positions, with everything else left as erasures. Prints one line a
    configuration and returns the number of failures."""
    dev = resolve_device(device)
    failures = 0
    for scheme, t2, t3, rate in PUNCT_CONFIGS:
        mlen = t2 * rate
        mother = torch.arange(mlen, dtype=torch.int32, device=dev) % 255
        p = rcpc.puncture(scheme, mother, t3)
        d = rcpc.depuncture_hard(scheme, p, mlen)
        keep = d != 255
        ok = bool(torch.equal(d[keep], mother[keep])) \
            and int(keep.sum()) == t3
        print(f"==> Puncture/Depuncture {scheme} ({t2}/{t3}): "
              f"{'OK' if ok else 'FAIL'}")
        failures += not ok
    return failures


def loopback_soak(iterations: int = 100, seed: int = 0, device=None) -> int:
    """Randomized encode -> decode soak (conv_enc_test.c:335-346),
    batched: SCH/F blocks and ACCESS-ASSIGN bits from default_rng(seed)
    in normal bursts; returns the number of blocks that fail their CRC
    or decode to other bits."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    init = scramb_get_init(262, 42, 1)
    schf = rng.integers(0, 2, size=(iterations, 268)).astype(np.int8)
    aach = rng.integers(0, 2, size=(iterations, 14)).astype(np.int8)
    t5 = tx.encode_block("SCH_F", schf, init, dev).cpu().numpy()
    bb = tx.encode_bbk(aach, init, dev).cpu().numpy()
    bursts = np.stack([
        burst_mod.build_norm_c_d_burst(t5[i, :216], bb[i], t5[i, 216:], False)
        for i in range(iterations)])
    res = pipeline.decode_schf_burst(
        torch.as_tensor(bursts.astype(np.int8), device=dev),
        torch.tensor(init, dtype=torch.int64, device=dev))
    ok = res["SCH_F"].crc_ok.cpu().numpy()
    exact = (res["SCH_F"].type1.cpu().numpy() == schf).all(axis=-1)
    return int((~(ok & exact)).sum())


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m tetra_tpu_torch.selftest",
        description="puncture/depuncture self-test and encode/decode soak")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    rc = punct_test(args.device)
    if rc:
        print(f"puncture self-test: {rc} FAILURES")
        sys.exit(1)
    errs = loopback_soak(device=args.device)
    print(f"total number of CRC Errors: {errs}")
    sys.exit(1 if errs else 0)


if __name__ == "__main__":
    main()
