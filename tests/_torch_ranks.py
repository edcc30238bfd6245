"""Rank functions of the port's multi-rank tests (tests/test_torch_parallel.py
and tests/test_torch_distributed.py).

Each runs in a spawned rank process (tetra_tpu_torch.parallel.launch),
so this module imports only numpy, torch and the port: a rank checks
that neither jax nor tetra_tpu was loaded. The global inputs are built
in the test process and arrive as arguments; every rank cuts its own
shard (mesh.local_shard) and returns its output shards with its mesh
coordinates.
"""
import numpy as np


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def parallel_cases(rank: int, world: int, device, inp: dict) -> dict:
    """Every sharded case of tests/test_torch_parallel.py on this rank:
    the burst decode, the match map, the steady chain and the PFB on
    1-D meshes of every rank, the 2-D chain on a (2 host x world/2 chip)
    mesh, the fused chunk pipeline (hard, soft) on a carrier mesh, and
    the dry run's rank outputs."""
    from tetra_tpu_torch.parallel import dryrun, mesh as M
    from tetra_tpu_torch.parallel.launch import rank_env_check

    rank_env_check()
    mesh = M.make_mesh()
    time_mesh = M.make_mesh(axis_name="time")
    mesh2 = M.make_mesh_2d(hosts=2)
    sh = lambda x, spec, m=mesh: M.local_shard(x, m, spec, device)
    out = {"coords": {**M.mesh_coords(mesh), **M.mesh_coords(time_mesh)},
           "coords2": M.mesh_coords(mesh2)}

    d = inp["decode"]
    dec = M.sharded_burst_decode(mesh)(
        sh(d["bursts"], ("carrier", None, None)),
        sh(d["inits"], ("carrier",)), sh(d["kinds"], ("carrier", None)))
    out["decode"] = {k: _np(v) for k, v in dec.items()}

    out["match"] = _np(M.sharded_match_map(time_mesh)(
        sh(inp["match_bits"], (None, "time"), time_mesh)))

    c = inp["chain"]
    chain = M.sharded_locked_step(mesh, phase_bit=64, n_slots=c["S"],
                                  decoders=("schf",))(
        sh(c["re"], ("carrier", None)), sh(c["im"], ("carrier", None)),
        sh(c["inits"], ("carrier",)))
    out["chain"] = {k: _np(v) for k, v in chain.items()}

    p = inp["pfb"]
    cr, ci = M.sharded_pfb_channelize(time_mesh, p["n_chan"], p["J"])(
        sh(p["re"], ("time",), time_mesh), sh(p["im"], ("time",), time_mesh))
    out["pfb"] = (_np(cr), _np(ci))

    spec_t = ("chip", "host")
    for key in ("chain2d", "layout2d"):
        c2 = inp[key]
        o2 = M.sharded_locked_step_2d(mesh2)(
            sh(c2["re"], spec_t, mesh2), sh(c2["im"], spec_t, mesh2),
            sh(c2["inits"], ("chip",), mesh2))
        out[key] = {k: _np(v) for k, v in o2.items()}

    car_mesh = M.make_mesh(axis_name="car")
    fast = {"fast_bits": inp["fast_bits"], "fast_cuts": inp["fast_cuts"]}
    out["fast"] = dryrun.run_fast(fast, device, car_mesh)
    out["fast_soft"] = dryrun.run_fast(fast, device, car_mesh, soft=True)

    out["dryrun"] = dryrun.rank_outputs(rank, world, device)
    rank_env_check()
    return out


def distributed_cases(rank: int, world: int, device, wide: dict) -> dict:
    """tests/test_torch_distributed.py on this rank: the two-host worker
    (tetra_tpu_torch.parallel.dist_worker), then the wideband entries on
    a carrier mesh of every rank: the mixer bank (every rank demodulates
    every carrier and walks its own, as tetra_tpu does) and the PFB
    (which raises)."""
    from tetra_tpu_torch.parallel import dist_worker, mesh as M
    from tetra_tpu_torch.parallel.launch import rank_env_check
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver

    dump = dist_worker.worker(rank, world, device)
    car_mesh = M.make_mesh(axis_name="car")
    mc = MultiCarrierReceiver(wide["offsets"], fs=wide["fs"],
                              control_plane="native", mesh=car_mesh,
                              device=device)
    mc.process_iq4c(wide["u8"][:wide["cut"]], final=False)
    mc.process_iq4c(wide["u8"][wide["cut"]:], final=True)
    f = mc._fast
    dump["mixer_stats"] = {
        c: (mc.carriers[c].stats.bursts, mc.carriers[c].stats.crc_ok,
            mc.carriers[c].stats.crc_wrong)
        for c in range(f.car0, f.car0 + f.n_local)}
    pfb = MultiCarrierReceiver([], fs=wide["fs"], control_plane="native",
                               pfb_channels=np.arange(len(wide["offsets"])),
                               n_chan=len(wide["offsets"]), mesh=car_mesh,
                               device=device)
    try:
        pfb.process_iq4c(wide["u8"])
        dump["pfb_error"] = None
    except NotImplementedError as e:
        dump["pfb_error"] = str(e)
    rank_env_check()
    return dump
