"""Multi-rank dry run (port of __graft_entry__.dryrun_multichip): run
every sharded path of the port on N ranks and VALUE-CHECK each sharded
output against the unsharded run of the port on the same inputs; ok
means numerics, not shapes.

Checked, as in tetra_tpu's dry run: the carrier-sharded burst decode
(kernel K1 on a card), the time-sharded match map with its halos, the
carrier-sharded steady chain, the carrier-sharded fused chunk pipeline
(FastChunkPipeline over a mesh, hard and soft: K1, and K4 when soft) on
a three-chunk capture, and, for an even N, the 2-D (host, chip) chain.

    python -m tetra_tpu_torch.parallel.dryrun --ranks N [--device cpu]

The ranks compute on cuda:0 unless --device cpu; the unsharded run is
made in this process on the same device. Exits non-zero on any
mismatch, and on a rank's failure.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

__all__ = ["inputs", "rank_outputs", "unsharded", "check", "run_fast",
           "FAST_KEYS"]

FAST_KEYS = ("carrier", "kind", "okA", "okB", "delta", "payload",
             "n_slots", "tail", "scramb")


def inputs(n: int, device) -> dict:
    """Every input of the dry run on n ranks, from fixed numpy seeds
    (the shapes of tetra_tpu's dry run at n devices)."""
    from tetra_tpu_torch import constants as C, testpdu, tx
    from tetra_tpu_torch.ops.scramble import scramb_get_init
    from tetra_tpu_torch.phy import dqpsk

    rng = np.random.default_rng(0)
    init = scramb_get_init(262, 42, 1)
    aach = testpdu.make_access_assign_bits()
    sync = np.asarray(tx.make_sync_burst(
        testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
        testpdu.make_sysinfo_pdu(), aach, init, device), np.int8)

    def schf(ssi):
        return np.asarray(tx.make_schf_burst(testpdu.make_resource_pdu(
            ssi=ssi), aach, init, device), np.int8)

    def planes(bits):
        iq = dqpsk.modulate(bits.astype(np.int8), sps=2)
        return (np.real(iq).astype(np.float32),
                np.imag(iq).astype(np.float32))

    inp = {"n": n}
    # carrier-sharded burst decode: 2 carriers a rank, one slot each
    nb = 2 * n
    inp["bursts"] = np.stack([sync if c % 2 == 0 else schf(0x100 + c)
                              for c in range(nb)])[:, None, :]
    inp["kinds"] = (np.arange(nb) % 2).astype(np.int32)[:, None]
    inp["inits"] = np.full(nb, init, np.uint32)
    # time-sharded correlation: a training sequence straddling a shard
    # boundary
    T = n * 128
    bits = rng.integers(0, 2, size=(2, T)).astype(np.int8)
    inp["edge"] = 128 * (n // 2) - 10
    bits[0, inp["edge"]:inp["edge"] + len(C.TRAIN_Y)] = C.TRAIN_Y
    inp["match_bits"] = bits
    # carrier-sharded steady chain: one carrier a rank, 2 SCH/F slots
    rows = np.stack([np.concatenate([schf(c * 8 + s) for s in range(2)])
                     for c in range(n)])
    pad = np.zeros((n, 64), np.int8)
    inp["chain_re"], inp["chain_im"] = planes(
        np.concatenate([pad, rows, pad], axis=1))
    # the fused chunk pipeline: garbage head, (SYNC + 3 SCH/F) twice, a
    # zero tail that lets the scan drain the ring; three uneven chunks
    rows_f = []
    for c in range(2 * n):
        seq = [sync.astype(np.uint8)] + [schf(0x900 + c * 4 + s).astype(
            np.uint8) for s in range(3)]
        rows_f.append(np.concatenate(
            [rng.integers(0, 2, 97 + 31 * c).astype(np.uint8)] + seq * 2
            + [np.zeros(1300, np.uint8)]))
    Lf = min(len(r) for r in rows_f)
    inp["fast_bits"] = np.stack([r[:Lf] for r in rows_f])
    inp["fast_cuts"] = [0, Lf // 3, Lf // 3 + 617, Lf]
    # 2-D (host, chip): n carriers, 2 slots a host
    if n >= 2 and n % 2 == 0:
        s2 = np.zeros((n, 4, 510), np.int8)
        for c in range(n):
            for s in range(4):
                s2[c, s] = sync if (c + s) % 2 == 0 else schf(c * 16 + s)
        inp["re2"], inp["im2"] = planes(s2.reshape(n, -1))
    return inp


def run_fast(inp: dict, device, mesh=None, soft: bool = False) -> list:
    """The fused chunk pipeline over the capture's three chunks; on a
    mesh every rank collects the gathered (whole) chunk."""
    from tetra_tpu_torch.fastpath import FastChunkPipeline
    bits, cuts = inp["fast_bits"], inp["fast_cuts"]
    fp = FastChunkPipeline(bits.shape[0], device, soft=soft, mesh=mesh)
    outs = []
    for i in range(len(cuts) - 1):
        h = fp.submit(bits[:, cuts[i]:cuts[i + 1]])
        if h is not None:
            outs.append({k: v for k, v in fp.collect(h).items()
                         if k in FAST_KEYS})
    return outs


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def rank_outputs(rank: int, world: int, device) -> dict:
    """One rank's shards of every sharded output, with its coordinates
    on each mesh and its kernel launch counts."""
    from tetra_tpu_torch import kernels
    from tetra_tpu_torch.parallel import mesh as M
    from tetra_tpu_torch.parallel.launch import rank_env_check

    rank_env_check()
    kernels.reset_launches()
    inp = inputs(world, device)
    mesh = M.make_mesh()
    time_mesh = M.make_mesh(axis_name="time")
    sh = lambda x, spec, m=mesh: M.local_shard(x, m, spec, device)
    out = {"coords": {**M.mesh_coords(mesh), **M.mesh_coords(time_mesh)}}
    dec = M.sharded_burst_decode(mesh)(
        sh(inp["bursts"], ("carrier", None, None)),
        sh(inp["inits"], ("carrier",)), sh(inp["kinds"], ("carrier", None)))
    out["decode"] = {k: _np(v) for k, v in dec.items()}
    out["match"] = _np(M.sharded_match_map(time_mesh)(
        sh(inp["match_bits"], (None, "time"), time_mesh)))
    chain = M.sharded_locked_step(mesh, phase_bit=64, n_slots=2,
                                  decoders=("schf",))(
        sh(inp["chain_re"], ("carrier", None)),
        sh(inp["chain_im"], ("carrier", None)),
        sh(inp["inits"][:world], ("carrier",)))
    out["chain"] = {k: _np(v) for k, v in chain.items()}
    car_mesh = M.make_mesh(axis_name="car")
    out["fast"] = run_fast(inp, device, car_mesh)
    out["fast_soft"] = run_fast(inp, device, car_mesh, soft=True)
    if "re2" in inp:
        mesh2 = M.make_mesh_2d(hosts=2)
        spec_t = ("chip", "host")
        o2 = M.sharded_locked_step_2d(mesh2)(
            sh(inp["re2"], spec_t, mesh2), sh(inp["im2"], spec_t, mesh2),
            sh(inp["inits"][:world], ("chip",), mesh2))
        out["coords2"] = M.mesh_coords(mesh2)
        out["chain2d"] = {k: _np(v) for k, v in o2.items()}
    out["launches"] = kernels.launches()
    rank_env_check()
    return out


def unsharded(inp: dict, device) -> dict:
    """The port's one-process run of every dry-run path."""
    from tetra_tpu_torch.lmac import pipeline, steady
    from tetra_tpu_torch.phy import burst as burst_mod
    t = lambda x: torch.as_tensor(
        x.astype(np.int64) if x.dtype == np.uint32 else x, device=device)
    n = inp["n"]
    inits = t(inp["inits"])
    bursts = t(inp["bursts"])
    ref = {"schf": pipeline.decode_schf_burst(bursts, inits[:, None]),
           "sync": pipeline.decode_sync_burst(bursts, inits[:, None]),
           "match": _np(burst_mod.train_seq_match(t(inp["match_bits"]))),
           "chain": steady.locked_step_ri(
               t(inp["chain_re"]), t(inp["chain_im"]), inits[:n],
               phase_bit=64, n_slots=2, decoders=("schf",)),
           "fast": run_fast(inp, device),
           "fast_soft": run_fast(inp, device, soft=True)}
    if "re2" in inp:
        ref["chain2d"] = steady.locked_step_ri(
            t(inp["re2"]), t(inp["im2"]), inits[:n], phase_bit=0,
            n_slots=4, decoders=("fused",))
    return ref


def _eq(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"{what}: sharded != unsharded "
                             f"({a.shape} vs {b.shape})")


def check(outs: list, ref: dict, inp: dict) -> dict:
    """Stitch the ranks' shards and hold each against the unsharded run;
    raises AssertionError on the first mismatch. Returns the counts."""
    from tetra_tpu_torch.parallel.mesh import MAX_TRAIN_LEN, stitch
    n = inp["n"]
    cs = lambda key, sub, spec: stitch(
        [(o["coords"], o[key][sub] if sub else o[key]) for o in outs], spec,
        {"carrier": n, "time": n})
    kinds = inp["kinds"]
    m1, m0 = kinds == 1, kinds == 0
    schf_t1 = cs("decode", "schf_type1", ("carrier",))
    sb1_t1 = cs("decode", "sb1_type1", ("carrier",))
    _eq(schf_t1[m1], _np(ref["schf"]["SCH_F"].type1)[m1], "decode schf")
    _eq(sb1_t1[m0], _np(ref["sync"]["SB1"].type1)[m0], "decode sb1")
    totals = {int(o["decode"]["crc_ok_total"]) for o in outs}
    if totals != {kinds.size}:
        raise AssertionError(f"decode crc_ok_total {totals}")

    match = cs("match", None, (None, "time"))
    valid = inp["match_bits"].shape[1] - (MAX_TRAIN_LEN - 1)
    _eq(match[:, :valid], ref["match"][:, :valid], "match map")
    if not match[0, inp["edge"], 0]:
        raise AssertionError("the planted training sequence was missed")

    for key in ("kinds", "schf_type1"):
        want = (_np(ref["chain"]["kinds"]) if key == "kinds"
                else _np(ref["chain"]["schf"].type1))
        _eq(cs("chain", key, ("carrier",)), want, f"chain {key}")
    if {int(o["chain"]["crc_ok_total"]) for o in outs} != {2 * n}:
        raise AssertionError("chain crc_ok_total")

    counts = {}
    for mode in ("fast", "fast_soft"):
        for o in outs:
            if len(o[mode]) != len(ref[mode]) or not ref[mode]:
                raise AssertionError(f"{mode}: chunk counts differ")
            for i, (a, b) in enumerate(zip(o[mode], ref[mode])):
                for key in FAST_KEYS:
                    _eq(a[key], b[key], f"{mode} chunk {i} {key}")
        ok = sum(int(d["okA"].sum()) for d in ref[mode])
        if ok < 2 * n * 4:
            raise AssertionError(f"{mode}: {ok} CRC-OK blocks")
        counts[f"{mode}_crc_ok"] = ok

    if "re2" in inp:
        sizes = {"host": 2, "chip": n // 2}
        for key, want in (("kinds", ref["chain2d"]["kinds"]),
                          ("crc_ok", ref["chain2d"]["crc_ok"]),
                          ("schf_type1", ref["chain2d"]["schf"].type1)):
            got = stitch([(o["coords2"], o["chain2d"][key]) for o in outs],
                         ("chip", "host"), sizes)
            _eq(got, _np(want), f"2-D chain {key}")
        tot = {int(o["chain2d"]["crc_ok_total"]) for o in outs}
        if tot != {n * 4}:
            raise AssertionError(f"2-D crc_ok_total {tot}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from tetra_tpu_torch.device import resolve_device
    from tetra_tpu_torch.parallel.launch import launch
    dev = resolve_device(a.device)
    outs = launch(rank_outputs, a.ranks, device=a.device,
                  threads=1 if dev.type == "cpu" else 0)
    inp = inputs(a.ranks, dev)
    counts = check(outs, unsharded(inp, dev), inp)
    launches = {k: sum(o["launches"][k] for o in outs)
                for k in outs[0]["launches"]}
    print(f"dry run on {a.ranks} ranks ({dev}): every sharded output "
          f"equals the unsharded run; {counts}; kernel launches on the "
          f"ranks {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
