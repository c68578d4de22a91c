"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` is compiled on its own, at first use, into
``build/surya_tpu_torch/<name>-<hash>.so`` beside the package, where the
hash covers every source in ``csrc/`` and the compiler flags, so a changed
source is rebuilt and an unchanged one is reused. The sources expose a
plain C interface (no PyTorch headers), which keeps a build to seconds.
:func:`build_all` starts one nvcc per source, all at once.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()``; :func:`check` raises
when that is not 0, so a refused launch never passes silently.

The sources launch on the CUDA runtime's *current* device (and set their
kernels' shared-memory attributes and query occupancy there), while the
stream comes from the tensors' device. :func:`launch` therefore makes the
tensors' device current around every call, so a wrapper launches on its
tensors' card whatever device the caller has current. Without it, a
tensor on ``cuda:1`` while device 0 is current meets another card's
stream: on four H100s each wrapper's launch was refused or faulted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "surya_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)


def build_all(names) -> None:
    """Compile every named source that is not built yet, in parallel."""
    with _lock:
        jobs = [j for j in (_start(n) for n in names) if j is not None]
        try:
            for job in jobs:
                _finish(job)
        finally:
            for proc, _, _ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


P, I = ctypes.c_void_p, ctypes.c_int  # pointer/stream, int argument
U, F, L = ctypes.c_uint32, ctypes.c_float, ctypes.c_longlong


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` set from ``signatures`` and every ``restype`` int."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                for fn, argtypes in signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[name] = lib
    return lib


def build_and_open(name: str) -> Path:
    """Build ``csrc/<name>.cu`` unless it is built, and open the library:
    → its path. Raises what nvcc or the loader reports (``check``'s probe
    of each kernel)."""
    build_all([name])
    path = _lib_path(name)
    ctypes.CDLL(str(path))
    return path


def nvcc_version() -> tuple[str, str]:
    """(nvcc's path, its release line). Raises when there is no toolkit."""
    nvcc = _nvcc()
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return nvcc, next((line for line in out.splitlines() if "release" in line),
                      out.strip().splitlines()[-1])


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def same_device(what: str, device, *tensors) -> None:
    """Raise unless every tensor lies on ``device`` (the kernel reads its
    operands through plain pointers)."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: operand on {t.device}, input on "
                             f"{device}")


def launch(what: str, fn, device, *args) -> None:
    """``fn(*args, stream)`` with ``device`` the current CUDA device and
    ``stream`` its current stream; raises what :func:`check` raises."""
    with torch.cuda.device(device):
        err = fn(*args, ctypes.c_void_p(
            torch.cuda.current_stream(device).cuda_stream))
    check(err, what)
