"""The two-host worker (port of tools/dist_worker.py): the mesh of ranks
that docs/MULTIHOST.md launches, as runnable code.

Each rank joins one gloo group (launch.py) and runs two phases:

1. The 2-D (host, chip) mesh over the ranks (hosts = 2): each host rank
   materialises ONLY its own time window of a deterministic capture
   (`build_capture`, mesh.local_shard), then the halo-exchanged
   `sharded_locked_step_2d` chain. The rank returns its output shards
   with its mesh coordinates and the summed CRC-OK count.
2. The fast path across ranks: MultiCarrierReceiver's native plane over
   a carrier mesh of every rank (FastChunkPipeline's sharded chunk and
   collect_local): each rank fetches and walks ONLY its own carriers,
   the reference's one-process-per-carrier scaling (src/receiver1:8).
   The rank returns the carriers it owns, its TL-SDU sink entries and
   its per-carrier stats.

Stitched together, the shards, the sink entries and the stats equal a
one-process receiver's on the same captures (tests/test_torch_distributed.py
holds them to the JAX package's).

Usage: python -m tetra_tpu_torch.parallel.dist_worker OUTDIR
[--ranks 2] [--device cpu]; writes OUTDIR/out<rank>.pkl.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

__all__ = ["build_capture", "build_bits_capture", "run_fastpath_phase",
           "worker", "CC", "S_TOTAL", "FAST_CARRIERS", "HOSTS"]

CC, S_TOTAL = 8, 4      # carriers, total slots (S_TOTAL / hosts per host)
FAST_CARRIERS = 8       # carriers of the fast-path phase
HOSTS = 2


def build_capture(device="cpu"):
    """Deterministic mixed SYNC/SCH-F capture (re, im [CC, T] float32,
    inits [CC] uint32), the same as tools/dist_worker.build_capture."""
    from tetra_tpu_torch import testpdu, tx
    from tetra_tpu_torch.ops.scramble import scramb_get_init
    from tetra_tpu_torch.phy import dqpsk

    init = scramb_get_init(262, 42, 1)
    aach = testpdu.make_access_assign_bits()
    sync = tx.make_sync_burst(testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
                              testpdu.make_sysinfo_pdu(), aach, init, device)
    slots = np.zeros((CC, S_TOTAL, 510), np.int8)
    for c in range(CC):
        for s in range(S_TOTAL):
            slots[c, s] = sync if (c + s) % 2 == 0 else tx.make_schf_burst(
                testpdu.make_resource_pdu(ssi=c * 16 + s), aach, init,
                device)
    iq = dqpsk.modulate(slots.reshape(CC, -1), sps=2)
    return (np.real(iq).astype(np.float32), np.imag(iq).astype(np.float32),
            np.full(CC, init, np.uint32))


def build_bits_capture(n_car: int, device="cpu") -> np.ndarray:
    """Per-carrier hard-bit streams for the fast-path phase (the same as
    tools/dist_worker.build_bits_capture): garbage head, double SYNC
    (acquisition eats the first), SCH/F resources carrying MLE/CMCE
    D-SETUP TL-SDUs, zero tail so the ring drains. Every rank builds the
    identical capture and uploads its own rows."""
    from tetra_tpu_torch import testpdu, tx
    from tetra_tpu_torch.ops.scramble import scramb_get_init

    init = scramb_get_init(262, 42, 1)
    aach = testpdu.make_access_assign_bits()
    sync = np.asarray(tx.make_sync_burst(
        testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
        testpdu.make_sysinfo_pdu(), aach, init, device), np.uint8)
    rows = []
    for c in range(n_car):
        rng = np.random.default_rng(7000 + c)
        parts = [rng.integers(0, 2, 97 + 13 * c).astype(np.uint8), sync,
                 sync]
        for s in range(6):
            sdu = testpdu.make_bl_udata(testpdu.make_mle_cmce_dsetup())
            parts.append(np.asarray(tx.make_schf_burst(
                testpdu.make_resource_pdu(ssi=0x500 + 16 * c + s,
                                          sdu_bits=sdu),
                aach, init, device), np.uint8))
        parts.append(np.zeros(1300, np.uint8))
        rows.append(np.concatenate(parts))
    L = min(len(r) for r in rows)
    return np.stack([r[:L] for r in rows])


def sink_entry(c, pdisc, pdut, bits) -> tuple:
    """A TL-SDU sink call as a comparable record."""
    b = np.asarray(bits)
    return (int(c), int(pdisc), int(pdut), np.packbits(b).tobytes(), len(b))


def run_fastpath_phase(mesh, device, n_car: int = FAST_CARRIERS):
    """The native receiver over a carrier mesh: the bits capture in three
    chunks, this rank walking its own carriers. Returns (owned carriers,
    TL-SDU sink entries, [(carrier, crc_ok, crc_wrong, slots)])."""
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver

    bits = build_bits_capture(n_car, device)
    sink = []
    mc = MultiCarrierReceiver(
        np.zeros(n_car), fs=25e3 * n_car, control_plane="native",
        mesh=mesh, device=device,
        tl_sdu_sink=lambda *a: sink.append(sink_entry(*a)))
    L = bits.shape[1]
    cuts = [0, L // 3, 2 * L // 3, L]
    for k in range(3):
        mc.process_bits(bits[:, cuts[k]:cuts[k + 1]], final=k == 2)
    f = mc._fast
    owned = list(range(f.car0, f.car0 + f.n_local))
    stats = [(c, mc.carriers[c].stats.crc_ok, mc.carriers[c].stats.crc_wrong,
              mc.carriers[c].stats.slots) for c in owned]
    return owned, sink, stats


def worker(rank: int, world: int, device) -> dict:
    """One rank of the worker: the 2-D chain on this host's time window,
    then the fast-path phase (see the module docstring)."""
    from tetra_tpu_torch.parallel import mesh as M
    from tetra_tpu_torch.parallel.launch import rank_env_check

    rank_env_check()
    mesh2 = M.make_mesh_2d(hosts=HOSTS)
    step = M.sharded_locked_step_2d(mesh2)
    re_g, im_g, inits = build_capture(device)
    spec_t = ("chip", "host")
    out = step(M.local_shard(re_g, mesh2, spec_t, device),
               M.local_shard(im_g, mesh2, spec_t, device),
               M.local_shard(inits, mesh2, ("chip",), device))
    coords = M.mesh_coords(mesh2)
    dump = {"coords": coords, "crc_ok_total": int(out["crc_ok_total"]),
            "sizes": {a: M.mesh_size(mesh2, a)
                      for a in mesh2.mesh_dim_names}}
    for key in ("kinds", "crc_ok", "schf_type1"):
        dump[key] = out[key].cpu().numpy()

    owned, sink, fstats = run_fastpath_phase(M.make_mesh(axis_name="car"),
                                             device)
    dump.update(fast_owned=owned, fast_sink=sink, fast_stats=fstats)
    rank_env_check()
    return dump


def stitch_dumps(dumps: list, key: str) -> np.ndarray:
    """One output of the 2-D phase, stitched from every rank's shard."""
    from tetra_tpu_torch.parallel.mesh import stitch
    spec = ("chip", "host")
    return stitch([(d["coords"], d[key]) for d in dumps], spec,
                  dumps[0]["sizes"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from tetra_tpu_torch.parallel.launch import launch
    dumps = launch(worker, a.ranks, device=a.device,
                   threads=1 if a.device == "cpu" else 0)
    os.makedirs(a.outdir, exist_ok=True)
    for r, d in enumerate(dumps):
        with open(os.path.join(a.outdir, f"out{r}.pkl"), "wb") as f:
            pickle.dump(d, f)
    print(f"{a.ranks} ranks: crc_ok_total {dumps[0]['crc_ok_total']}, "
          f"fast-path carriers {sum(len(d['fast_owned']) for d in dumps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
