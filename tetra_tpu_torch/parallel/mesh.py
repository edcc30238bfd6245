"""Device meshes of torch.distributed ranks (port of
tetra_tpu.parallel.mesh).

The reference scales by running one OS process per carrier glued with
FIFOs/UDP (reference src/receiver1:8, src/receiver1udp:71-78). The JAX
package makes that a sharded program over a device mesh; here every
element of the mesh is a rank, one process with its own CUDA context,
and the program runs once per rank on that rank's shard:

- carriers   -> data-parallel axis ("carrier"), sharded over ranks
- time       -> sequence axis; the training-sequence correlator, the
  channelizer and the matched filter need halos at shard boundaries,
  exchanged with the ring neighbours (jax.lax.ppermute)
- bookkeeping (CRC counters) -> a sum over the mesh (jax.lax.psum)

A mesh is a torch.distributed DeviceMesh over a gloo process group of
every rank (launch.py starts them), built for its groups only: it is
created with device type "cpu" from groups made here, each with the
launch's timeout, because init_device_mesh("cuda", ...) would pick NCCL
and call set_device(rank % count), and NCCL refuses several ranks on one
card. The compute device is passed to the functions explicitly (the
shard tensors carry it). Every payload between ranks goes through
`collectives`, staged through host memory.

Each `sharded_*` function returns a callable that takes this rank's
shard of each input and returns this rank's shard of each output (and
the replicated counts). `local_shard` cuts a global array into this
rank's shard by the JAX in_specs (the counterpart of
jax.make_array_from_process_local_data), and `stitch` puts the shards
of every rank back together.
"""
from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.parallel import collectives

__all__ = ["make_mesh", "make_mesh_2d", "sharded_burst_decode",
           "sharded_locked_step", "sharded_locked_step_2d",
           "sharded_pfb_channelize", "sharded_match_map", "MAX_TRAIN_LEN",
           "local_shard", "mesh_coords", "mesh_size", "stitch", "TIMEOUT"]

MAX_TRAIN_LEN = 38  # longest training sequence (y, 38 bits)
# every collective of a mesh's groups (and of the launch's group) fails
# after this long
TIMEOUT = timedelta(seconds=300)


def _group(rows: list[list[int]]) -> dist.ProcessGroup:
    """This rank's group among `rows` (disjoint rank lists covering the
    world), with TIMEOUT on its collectives; every rank creates every
    group, as new_group requires."""
    if rows == [list(range(dist.get_world_size()))]:
        return dist.group.WORLD      # the launch gave it TIMEOUT
    mine, _ = dist.new_subgroups_by_enumeration(rows, timeout=TIMEOUT,
                                                backend="gloo")
    return mine


def make_mesh(axis_name: str = "carrier") -> DeviceMesh:
    """1-D mesh over every rank, carriers sharded across it (the
    counterpart of tetra_tpu's make_mesh over all devices)."""
    ranks = list(range(dist.get_world_size()))
    return DeviceMesh.from_group(_group([ranks]), "cpu",
                                 mesh=torch.tensor(ranks),
                                 mesh_dim_names=(axis_name,))


def make_mesh_2d(hosts: int = 2,
                 axis_names: tuple = ("host", "chip")) -> DeviceMesh:
    """2-D (host, chip) mesh over every rank: the ingest/time axis
    shards over hosts, carriers shard over each host's chips. Rank r
    sits at host r // (n / hosts), chip r % (n / hosts)."""
    n = dist.get_world_size()
    if n % hosts:
        raise ValueError(f"{n} ranks do not split over {hosts} hosts")
    grid = np.arange(n).reshape(hosts, -1)
    host_g = _group([grid[:, j].tolist() for j in range(grid.shape[1])])
    chip_g = _group([grid[i, :].tolist() for i in range(hosts)])
    return DeviceMesh.from_group([host_g, chip_g], "cpu",
                                 mesh=torch.tensor(grid),
                                 mesh_dim_names=tuple(axis_names))


def mesh_size(mesh: DeviceMesh, axis: str) -> int:
    """Number of ranks along the named dimension."""
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def mesh_coords(mesh: DeviceMesh) -> dict:
    """This rank's index along each named dimension."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def _slices(shape, spec, mesh: DeviceMesh, coords: dict) -> tuple:
    out = []
    for d, a in enumerate(spec):
        if a is None:
            out.append(slice(None))
            continue
        n = mesh_size(mesh, a)
        if shape[d] % n:
            raise ValueError(f"dim {d} ({shape[d]}) does not split over "
                             f"{n} shards of {a!r}")
        w = shape[d] // n
        out.append(slice(coords[a] * w, (coords[a] + 1) * w))
    return tuple(out)


def local_shard(x, mesh: DeviceMesh, spec: tuple, device=None):
    """This rank's shard of the global array x under the JAX
    PartitionSpec `spec` (one mesh dimension name, or None, per array
    dimension); a tensor on `device` when given, else numpy."""
    x = np.asarray(x)
    part = np.ascontiguousarray(
        x[_slices(x.shape, spec, mesh, mesh_coords(mesh))])
    if device is None:
        return part
    if part.dtype == np.uint32:
        part = part.astype(np.int64)
    return torch.as_tensor(part, device=device)


def stitch(pieces, spec: tuple, sizes: dict) -> np.ndarray:
    """The global array from every rank's (coords, shard) under `spec`;
    sizes maps each mesh dimension name to its length."""
    pieces = [(c, np.asarray(a)) for c, a in pieces]
    a0 = pieces[0][1]
    shape = tuple(s * (sizes[a] if a is not None else 1)
                  for s, a in zip(a0.shape, tuple(spec) + (None,) * a0.ndim))
    out = np.zeros(shape, a0.dtype)
    for coords, a in pieces:
        idx = tuple(slice(coords[ax] * s, (coords[ax] + 1) * s)
                    if ax is not None else slice(None)
                    for s, ax in zip(a.shape, tuple(spec) + (None,) * a.ndim))
        out[idx] = a
    return out


def _count(ok: torch.Tensor) -> torch.Tensor:
    return ok.to(torch.int64).sum()


def sharded_burst_decode(mesh: DeviceMesh, axis: str = "carrier"):
    """Multi-carrier slot decoder on this rank's carriers.

    fn(bursts [C, S, 510] int8, inits [C] int64, kinds [C, S] int32)
    (this rank's carriers; in_specs P(axis, None, None), P(axis),
    P(axis, None)) -> dict of decoded blocks + the global CRC-OK count
    (summed over the axis). kinds: 0 SYNC / 1 SCH/F / 2 NDB / -1 none.
    One kind-compacted fused decode (lmac.fused, kernel K1 on a card)
    decodes every slot under its own interpretation, so each kind's
    fields are meaningful only on slots OF that kind."""
    from tetra_tpu_torch.lmac import fused as fused_mod
    group = mesh.get_group(axis)

    def step(bursts, inits, kinds):
        res = fused_mod.decode_slots_fused(bursts, inits[:, None], kinds)
        out = {"crc_ok": res["crc_ok"],
               "crc_ok_total": collectives.all_reduce_sum(
                   _count(res["crc_ok"]), group),
               "bbk_type1": res["bbk"].type1}
        for k in ("sb1", "sb2", "schf", "ndb1", "ndb2"):
            out[k + "_type1"] = res[k].type1
            out[k + "_ok"] = res[k].crc_ok
        return out
    return step


def sharded_locked_step(mesh: DeviceMesh, axis: str = "carrier",
                        phase_bit: int = 0, sps: int = 2,
                        n_slots: int | None = None,
                        decoders: tuple = ("sync", "schf", "ndb")):
    """Steady-state full chain on this rank's carriers.

    fn(re [C, T], im [C, T], inits [C]) (in_specs P(axis, None) twice,
    P(axis)) -> locked_step outputs of these carriers plus the global
    CRC-OK count. The per-carrier chain (lmac.steady.locked_step_ri,
    fast=True) has no cross-carrier dependence, so the only collective
    is the count's sum."""
    from tetra_tpu_torch.lmac import steady
    group = mesh.get_group(axis)

    def step(re, im, inits):
        out = steady.locked_step_ri(re, im, inits, phase_bit=phase_bit,
                                    sps=sps, n_slots=n_slots,
                                    decoders=decoders)
        return {"kinds": out["kinds"], "crc_ok": out["crc_ok"],
                "schf_type1": (out["schf"].type1 if "schf" in decoders
                               else None),
                "crc_ok_total": collectives.all_reduce_sum(
                    _count(out["crc_ok"]), group)}
    return step


def sharded_locked_step_2d(mesh: DeviceMesh, sps: int = 2,
                           decoders: tuple = ("fused",),
                           host_axis: str = "host",
                           chip_axis: str = "chip"):
    """Steady-state full chain on a 2-D (host, chip) mesh.

    fn(re [C, T], im [C, T], inits [C]) on this rank's shard: carriers
    sharded over `chip_axis`, TIME over `host_axis` (in_specs
    P(chip, host) twice, P(chip)): each host holds only its own time
    window, T a host-multiple of whole slots, slot boundaries at bit 0.

    Exactness against the unsharded chain: the RRC matched filter and
    the differential lag need h_left = ntaps//2 + sps samples of left
    and h_right = ntaps-1-ntaps//2 of right context, received from the
    time-neighbours over the host group; shards at the stream edges get
    the zero context the unsharded demod uses. The per-phase timing
    score is summed over the host group in host order (partial scores
    all-gathered and added rank by rank, so an argmax tie falls the same
    way on every rank and, for two hosts, as a JAX psum's a + b).
    Then lmac.steady.locked_step_bits with `decoders`, and the CRC-OK
    count summed over both axes."""
    from tetra_tpu_torch.lmac import steady
    from tetra_tpu_torch.phy.dqpsk import _fir_real, rrc_taps

    taps = rrc_taps(sps)
    ntaps = len(taps)
    pad_l = ntaps // 2
    h_left = pad_l + sps
    h_right = ntaps - 1 - pad_l
    H = mesh_size(mesh, host_axis)
    hosts = mesh.get_group(host_axis)
    chips = mesh.get_group(chip_axis)

    def step(re, im, inits):
        T_loc = re.shape[-1]
        idx = mesh.get_local_rank(host_axis)

        def ext(x):
            left = collectives.ring_shift(x[:, -h_left:], hosts, 1)
            right = collectives.ring_shift(x[:, :h_right], hosts, -1)
            if idx == 0:
                left = torch.zeros_like(left)       # stream start
            if idx == H - 1:
                right = torch.zeros_like(right)     # stream end
            return torch.cat([left, x, right], dim=-1)

        fr = _fir_real(ext(re), taps)
        fi = _fir_real(ext(im), taps)
        # differential phasor z[n] conj(z[n-sps]); the unsharded demod
        # zero-pads the lag at the stream start
        frc = fr[:, h_left:h_left + T_loc]
        fic = fi[:, h_left:h_left + T_loc]
        lr = fr[:, h_left - sps:h_left - sps + T_loc]
        li = fi[:, h_left - sps:h_left - sps + T_loc]
        if idx == 0:
            lr = lr.clone()
            li = li.clone()
            lr[:, :sps] = 0.0
            li[:, :sps] = 0.0
        dr = frc * lr + fic * li
        di = fic * lr - frc * li

        # timing phase: per-shard partial sums -> global argmax
        n = (T_loc // sps) * sps
        Cl = dr.shape[0]
        drp = dr[:, :n].reshape(Cl, n // sps, sps)
        dip = di[:, :n].reshape(Cl, n // sps, sps)
        mag2 = drp * drp + dip * dip
        part = torch.sum(2.0 * torch.abs(drp * dip) / (mag2 + 1e-12),
                         dim=-2)
        parts = collectives.all_gather(part, hosts)
        score = parts[0]
        for p in parts[1:]:
            score = score + p
        best = torch.argmax(score, dim=-1)
        idx_b = best[:, None, None].expand(Cl, n // sps, 1)
        sel_r = drp.gather(2, idx_b)[..., 0]
        sel_i = dip.gather(2, idx_b)[..., 0]
        b0 = (sel_i <= 0).to(torch.int8)
        b1 = (sel_r < 0).to(torch.int8)
        bits = torch.stack([b0, b1], dim=-1).reshape(Cl, -1)

        S = bits.shape[-1] // C.BITS_PER_TS
        slots = bits[:, :S * C.BITS_PER_TS].reshape(Cl, S, C.BITS_PER_TS)
        out = steady.locked_step_bits(slots, inits, decoders=decoders)
        total = collectives.all_reduce_sum(
            collectives.all_reduce_sum(_count(out["crc_ok"]), hosts), chips)
        return {"kinds": out["kinds"], "crc_ok": out["crc_ok"],
                "schf_type1": out["schf"].type1, "crc_ok_total": total}
    return step


def sharded_pfb_channelize(mesh: DeviceMesh, n_chan: int,
                           taps_per_branch: int = 16, axis: str = "time"):
    """Time-sharded wideband channelizer with a halo exchange.

    fn(re [T], im [T]) on this rank's time shard (in_specs P(axis)
    twice) -> (chan_re [C, M], chan_im [C, M]), this shard's frames
    (out_specs P(None, axis)). Each shard receives nfilt - hop wideband
    samples from its right neighbour, so the windows spanning the
    boundary are exact (the last shard's windows that would wrap are
    garbage; mask by absolute position). The channelizer is the plain
    phy.pfb.pfb_channelize_ri, as the JAX package calls XLA here, not
    its Pallas kernel."""
    from tetra_tpu_torch.phy import pfb as pfb_mod
    group = mesh.get_group(axis)
    hop = n_chan // 2
    halo = n_chan * taps_per_branch - hop

    def step(re, im):
        def extend(x):
            h = collectives.ring_shift(x[:halo], group, -1)
            return torch.cat([x, h], dim=-1)
        return pfb_mod.pfb_channelize_ri(extend(re), extend(im), n_chan,
                                         taps_per_branch)
    return step


def sharded_match_map(mesh: DeviceMesh, axis: str = "time"):
    """Training-sequence correlation with a halo exchange.

    fn(bits [C, T] int8) on this rank's time shard (in_specs
    P(None, axis)) -> match [C, T, 5] bool of this shard (out_specs
    P(None, axis, None)). Each shard receives MAX_TRAIN_LEN-1 bits from
    its right neighbour, so windows spanning the boundary are exact:
    overlap-save, the sequence-parallel halo pattern."""
    from tetra_tpu_torch.phy import burst as burst_mod
    group = mesh.get_group(axis)

    def step(bits):
        halo = collectives.ring_shift(bits[:, :MAX_TRAIN_LEN - 1], group, -1)
        m = burst_mod.train_seq_match(torch.cat([bits, halo], dim=-1))
        # windows that would use the wrapped halo on the last shard are
        # masked by the caller via absolute position
        return m[:, :bits.shape[-1], :]
    return step
