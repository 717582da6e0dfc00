"""Build and load the hand-written CUDA kernels (ctypes).

``csrc/*.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, cached under ``_build/`` next to
the package and keyed by a hash of the sources, so an edit rebuilds it.
Nothing is built at import: the first launch builds, so the CPU test
suite, which never launches a kernel, needs no CUDA toolkit.

Each launcher returns ``cudaGetLastError()`` after its launch; ``check``
raises on a non-zero code.  ``LAUNCHES`` counts the kernel launches made
through the wrappers in ``ops.encode`` / ``ops.decode`` (one per launch,
nowhere else), so a run can show that its path went through the kernels;
``STREAM_LAUNCHES`` splits the same count by CUDA stream, which tells
apart the shards of a MeshCodec even when they share one card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches through the wrappers, by kernel: K1, K2 (release
# decode) and K3 (debug decode).
LAUNCHES = {"encode": 0, "decode": 0, "decode_debug": 0}
# The same launches by (kernel, CUDA stream handle).
STREAM_LAUNCHES: dict[tuple[str, int], int] = {}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    STREAM_LAUNCHES.clear()


def count(kernel: str, stream: int) -> None:
    """Record one launch of ``kernel`` on ``stream`` (a wrapper calls this
    right after its launch succeeded)."""
    LAUNCHES[kernel] += 1
    key = (kernel, stream)
    STREAM_LAUNCHES[key] = STREAM_LAUNCHES.get(key, 0) + 1


def launches_on(stream: int | None) -> dict[str, int]:
    """Launches per kernel on one CUDA stream since the last reset."""
    return {k: STREAM_LAUNCHES.get((k, stream), 0) for k in LAUNCHES}


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels of gpuar_tpu_torch are built "
        "from source at first use and need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_DIR / f"libgpuar_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ into the cached library (no-op when it exists)."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {r.returncode}):\n{' '.join(cmd)}\n"
            f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            # gpuar_encode(data, sizes, n, packet_size, out, stride,
            #              lengths, stream)
            lib.gpuar_encode.argtypes = [vp, vp, i32, i32, vp, i32, vp, vp]
            lib.gpuar_encode.restype = i32
            # gpuar_decode(blob, blob_len, offsets, region, raw_sizes, n,
            #              packet_size, out, flags, debug, stream)
            lib.gpuar_decode.argtypes = [vp, i64, vp, i32, vp, i32, i32, vp,
                                         vp, i32, vp]
            lib.gpuar_decode.restype = i32
            _LIB = lib
        return _LIB


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}")
