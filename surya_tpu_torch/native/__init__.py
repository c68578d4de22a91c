"""Host-side JPEG batch decoder (C++ via ctypes), a copy of
``surya_tpu/native``.

``decode_batch`` — multithreaded JPEG decode + bilinear resize backed by
``decode.cpp`` (libjpeg + std::thread). Built with g++ at first use into
``build/surya_tpu_torch/`` beside the package, keyed by a hash of the
source; ``available()`` reports whether the build and load succeeded, and
callers (``data/dataset.py``) use PIL when it did not. This is host
decoding: no device path and no kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "surya_tpu_torch"

_lock = threading.Lock()
_lib = None
_failed = False


def _so_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libsurya_decode-{digest}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(SRC), "-ljpeg", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = _so_path()
        if not so.exists() and not _build(so):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _failed = True
            return None
        lib.surya_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
        lib.surya_decode_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_batch(paths: list[str], out_size: int,
                 n_threads: int = 0) -> tuple[np.ndarray, int]:
    """Decode+resize a list of JPEG paths → ((N, S, S, 3) uint8, n_ok).

    Failed images come back zero-filled. The work runs in C++ threads
    with the GIL released (ctypes drops it for the call)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable "
                           "(no g++/libjpeg); use the PIL path")
    n = len(paths)
    out = np.zeros((n, out_size, out_size, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    n_ok = lib.surya_decode_batch(
        arr, n, out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_threads)
    return out, int(n_ok)
