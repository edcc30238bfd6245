"""Build and load the port's CUDA kernels.

Each source in `csrc/*.cu` compiles with its own nvcc process, all
started together, and the objects link into ONE shared library with a
plain C interface (no PyTorch headers: seconds per build), loaded with
ctypes. The library lands in `build/` at the repository root
(gitignored), named by a hash of the sources and flags, so an edit
rebuilds it and an unchanged tree reuses it.

Every exported launcher takes raw device pointers and the CUDA stream
as `void*`, launches on that stream without synchronising, and returns
`cudaGetLastError()`; `check()` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = ["lib", "check", "stream_ptr", "build", "occupancy", "wrappers",
           "launches", "reset_launches"]

_CSRC = pathlib.Path(__file__).parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
# exported launcher name -> ctypes argtypes (all return int = cudaError_t,
# except those in _RESTYPES)
_SIGNATURES = {
    "tt_viterbi_assembled": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P,
                             _P, _I, _P, _P, _I, _I, _P],
    "tt_viterbi_assembled_occupancy": [_I, _I, _I, _P],
    "tt_viterbi_segmented": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _I,
                             _I, _P],
    "tt_viterbi_segmented_occupancy": [_I, _I, _P],
    "tt_viterbi_decode": [_P, _I, _P, _I, _P, _I, _I, _P],
    "tt_viterbi_decode_occupancy": [_I, _I, _P],
    "tt_empty_launch": [_P],
    "tt_pfb_wola": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tt_pfb_wola_occupancy": [_I, _P],
    "tt_resample_rows": [_P, _P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I,
                         _I, _I, _I, _P, _P, _I, _P],
    "tt_resample_rows_occupancy": [_I, _I, _I, _I, _I, _P],
    "tt_demod_fused": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                       _P],
    "tt_demod_fused_sps_occupancy": [_I, _P],
    "tt_demod_fused_scratch": [_I, _I],
    "tt_sync_scan": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "tt_sync_scan_constants": [_P],
    "tt_sync_scan_occupancy": [_P],
    "tt_mixer_bank": [_P, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _LL, _D, _D, _I, _I, _I, _I, _P, _P, _P],
    "tt_mixer_bank_occupancy": [_I, _I, _P],
    "tt_error_string": [_I],
}

_RESTYPES = {"tt_error_string": ctypes.c_char_p,
             "tt_demod_fused_scratch": ctypes.c_longlong,
             "tt_sync_scan_constants": None}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "first use and need the CUDA toolkit")


def build() -> pathlib.Path:
    """Compile csrc/*.cu into build/kernels/libtetra_kernels-<hash>.so
    unless that file already exists (one nvcc per source, in parallel,
    then one link); returns its path."""
    srcs = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs + sorted(_CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = _BUILD / f"libtetra_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [_BUILD / f"{s.stem}-{tag}.o" for s in srcs]
    procs = [subprocess.Popen([_nvcc(), *_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [f"{s.name}:\n{log}" for s, p, log in zip(srcs, procs, logs)
              if p.returncode != 0]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run([_nvcc(), "-shared", "-gencode",
                              "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                              *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            failed.append("link:\n" + res.stdout + res.stderr)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = so
        return _lib


def stream_ptr(device: torch.device) -> int:
    """Raw handle of PyTorch's current CUDA stream on `device`, from the
    getter PyTorch's own generated kernels call: ~0.1 us a call on an
    H100 host, against ~15 us for torch.cuda.current_stream(device)
    .cuda_stream, which builds a Stream object (most of a small
    kernel's wrapper cost)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def occupancy(name: str, *args: int) -> dict:
    """Launch shape of a kernel (K1, K2, K3, K4, K5, K6, S1, M1; K5 at
    any rate as "tt_demod_fused_sps" with the rate as argument) at the
    given arguments: the exported `<name>_occupancy` fills resident blocks per
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per
    thread and shared bytes per block (cudaFuncGetAttributes plus the
    dynamic size) and threads per block."""
    out = (ctypes.c_int * 4)()
    check(getattr(lib(), f"{name}_occupancy")(*args, ctypes.addressof(out)),
          f"{name}_occupancy")
    return dict(zip(("blocks_per_sm", "regs_per_thread", "smem_per_block",
                     "threads_per_block"), out))


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib().tt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int) -> None:
    """Argument check shared by the kernel wrappers."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def wrappers() -> dict:
    """The kernel wrappers by kernel name. Each carries `launches`, the
    count of its kernel's launches in this process."""
    from tetra_tpu_torch.ops.viterbi_assembled import decode_assembled
    from tetra_tpu_torch.ops.viterbi_decode import decode_k6
    from tetra_tpu_torch.ops.viterbi_segmented import decode_segmented_k4
    from tetra_tpu_torch.phy.channelizer import mixer_bank
    from tetra_tpu_torch.phy.demod_fused import demod_fused
    from tetra_tpu_torch.phy.pfb import pfb_channelize_rows, resample_rows
    from tetra_tpu_torch.phy.sync_vec import sync_scan
    return {"viterbi_assembled": decode_assembled,
            "pfb_wola": pfb_channelize_rows,
            "resample_rows": resample_rows,
            "viterbi_segmented": decode_segmented_k4,
            "viterbi_decode": decode_k6,
            "demod_fused": demod_fused,
            "sync_scan": sync_scan,
            "mixer_bank": mixer_bank}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in wrappers().values():
        fn.launches = 0


def launches() -> dict:
    """Every wrapper's launch count."""
    return {k: fn.launches for k, fn in wrappers().items()}
