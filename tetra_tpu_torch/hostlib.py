"""Build and load the port's host library (`hostsrc/*.cpp`).

The C++ sources compile with one g++ call into a shared library with a
plain C interface, loaded with ctypes: no CUDA and no PyTorch headers,
so any machine with g++ builds it in about a second. The library lands
in `build/host/` at the repository root (gitignored), named by a hash of
the sources and flags, so an edit rebuilds it and an unchanged tree
reuses it. It is linked to a temporary name and renamed into place, so
processes that build it at once never load a half-written file.

`lib()` returns None where the library cannot be built or loaded (no
g++); callers then run their numpy versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import warnings

__all__ = ["lib", "build"]

_SRC = pathlib.Path(__file__).parent / "hostsrc"
_BUILD = pathlib.Path(__file__).resolve().parent.parent / "build" / "host"
_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# exported name -> (argtypes, restype)
_SIGNATURES = {
    "tt_parse_rows": ([_P, _LL, _P, _P, _P, _P, _P, _P], _LL),
}

_lock = threading.Lock()
_lib = None
_tried = False


def build() -> pathlib.Path:
    """Compile hostsrc/*.cpp into build/host/libtetra_host-<hash>.so
    unless that file already exists; returns its path. Raises
    FileNotFoundError without g++, RuntimeError if it fails."""
    srcs = sorted(_SRC.glob("*.cpp"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = _BUILD / f"libtetra_host-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([gxx, *_FLAGS, "-o", str(tmp), *map(str, srcs)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed:\n" + res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def lib():
    """The loaded host library (built on first call), or None where it
    cannot be built or loaded; the first failure warns once."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                so = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                warnings.warn(f"host library unavailable, numpy parse "
                              f"used instead: {e}", RuntimeWarning)
                return None
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = args
                fn.restype = res
            _lib = so
        return _lib
