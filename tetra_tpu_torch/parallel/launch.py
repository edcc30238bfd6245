"""Start the ranks of a mesh: N processes on one host, joined in one gloo
process group, computing on the CPU or all on cuda:0.

The card machine has one H100, so the ranks of a mesh share it, each
process with its own CUDA context (parallel/collectives.py says why the
group is gloo). `launch` builds the CUDA kernels in the parent before it
spawns anything, so the ranks load the built library and do not race to
build it; gives the process group and every collective the mesh's
timeout and the whole run a deadline; and fails with a rank's traceback
when a rank fails, after stopping the others.

A rank runs fn(rank, world, device, *args); fn is a module-level
function (it travels by import path) of a module that imports neither
jax nor tetra_tpu, and its return value comes back pickled.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

__all__ = ["launch", "free_port", "rank_env_check"]


def free_port() -> int:
    """An unused TCP port on 127.0.0.1 for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device: str, threads: int,
               fn, args: tuple, out) -> None:
    """One rank: join the group, run fn, report its result or its
    traceback, leave the group."""
    import torch
    import torch.distributed as dist

    from tetra_tpu_torch.device import resolve_device
    from tetra_tpu_torch.parallel.mesh import TIMEOUT
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = resolve_device(device)
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            result = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    out.put((rank, True, result))


def launch(fn, world: int, *args, device: str = "cuda",
           timeout: float = 900.0, threads: int = 0) -> list:
    """Run fn(rank, world, device, *args) on `world` ranks and return
    their results in rank order. device: "cuda" (every rank on cuda:0)
    or "cpu". threads: torch threads per rank (0 leaves torch's
    default). Raises RuntimeError with the traceback of the first rank
    that fails, or when a rank dies without a word, and TimeoutError
    when the ranks have not all returned within `timeout` seconds; the
    other ranks are stopped first."""
    if device != "cpu":
        from tetra_tpu_torch import kernels
        kernels.build()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, device, threads, fn, args,
                               out),
                         name=f"rank{r}", daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, payload = out.get(timeout=1.0)
            except queue.Empty:
                dead = [p for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    # a rank that died before reporting (killed, or its
                    # report is still in the pipe: give it a moment)
                    try:
                        rank, ok, payload = out.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"{dead[0].name} died with exit code "
                            f"{dead[0].exitcode} and no traceback") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world - len(results)} of {world} ranks still "
                        f"running after {timeout:.0f} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 10.0))
            if p.is_alive():
                raise TimeoutError(f"{p.name} did not exit")
            if p.exitcode != 0:
                raise RuntimeError(f"{p.name} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10.0)
        out.close()
    return [results[r] for r in range(world)]


def rank_env_check() -> None:
    """Raise when this process has loaded jax or tetra_tpu (a rank
    imports the port only)."""
    import sys
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tetra_tpu"))
    if bad:
        raise RuntimeError(f"rank {os.getpid()} imported {bad[:5]}")
