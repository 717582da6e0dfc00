"""Build and load the hand-written CUDA kernels (ctypes).

Each ``csrc/*.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, cached under ``_build/``
next to the package and keyed by a hash of the source and the shared
headers, so an edit rebuilds it.  ``build()`` starts one ``nvcc`` per
missing library, all at once.  Nothing is built at import: a wrapper's
first launch builds the library it needs (``function``), so the CPU test
suite, which never launches a kernel, needs no CUDA toolkit.  No source
is built with fast math: the probes' float32 tricks need IEEE rounding.
``BUILD_LOGS`` keeps what each build printed, ptxas's registers and
spills of every kernel among it.

Each launcher returns ``cudaGetLastError()`` after its launch; ``check``
raises on a non-zero code.  ``LAUNCHES`` counts the codec kernels'
launches made through the wrappers in ``ops.encode`` / ``ops.decode``
(one per launch, nowhere else), so a run can show that its path went
through the kernels; ``STREAM_LAUNCHES`` splits the same count by CUDA
stream, which tells apart the shards of a MeshCodec even when they share
one card.  The probes count theirs in ``gpuar_tpu_torch.probes.LAUNCHES``.
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
_LIBS: dict[str, ctypes.CDLL] = {}

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# Every C entry point: (the source that defines it, its argument types).
# Each returns a CUDA error code (int).
SIGNATURES = {
    # gpuar_encode(data, sizes, n, packet_size, out, stride, lengths,
    #              stream)
    "gpuar_encode": ("encode", [_VP, _VP, _I32, _I32, _VP, _I32, _VP, _VP]),
    # gpuar_encode_occupancy(*blocks_per_sm): gpuar_encode's blocks that one
    # SM of the current device holds at once
    "gpuar_encode_occupancy": ("encode", [_VP]),
    # gpuar_gather_body(packets, stride, ends, n, body, stream)
    "gpuar_gather_body": ("gather", [_VP, _I32, _VP, _I32, _VP, _VP]),
    # gpuar_decode(blob, blob_len, offsets, region, raw_sizes, n,
    #              packet_size, out, flags, debug, stream)
    "gpuar_decode": ("decode", [_VP, _I64, _VP, _I32, _VP, _I32, _I32, _VP,
                                _VP, _I32, _VP]),
    # gpuar_decode_shape(*threads, *smem_bytes): gpuar_decode's threads and
    # shared memory bytes per block
    "gpuar_decode_shape": ("decode", [_VP, _VP]),
    # gpuar_decode_occupancy(*blocks_per_sm): the same for gpuar_decode
    "gpuar_decode_occupancy": ("decode", [_VP]),
    # gpuar_probe_model(words, rows_in, tile, steps, repeat, variant, out,
    #                   table, stream)
    "gpuar_probe_model": ("probe_model", [_VP, _I32, _I32, _I32, _I32, _I32,
                                          _VP, _VP, _VP]),
    # gpuar_probe_model_shape(variant, *threads, *smem_bytes): a variant's
    # threads and dynamic shared memory bytes per block
    "gpuar_probe_model_shape": ("probe_model", [_I32, _VP, _VP]),
    # gpuar_probe_carry(tile, iters, ncarry, packed, unroll, out, stream)
    "gpuar_probe_carry": ("probe_model", [_I32, _I32, _I32, _I32, _I32, _VP,
                                          _VP]),
    # gpuar_probe_carry_shape(*threads, *smem_bytes)
    "gpuar_probe_carry_shape": ("probe_model", [_VP, _VP]),
    # gpuar_profile_encode(sizes, words, n, steps, level, out, out_words,
    #                      len, stream)
    "gpuar_profile_encode": ("profile_encode", [_VP, _VP, _I32, _I32, _I32,
                                                _VP, _I32, _VP, _VP]),
    # gpuar_profile_encode_shape(*threads, *smem_bytes)
    "gpuar_profile_encode_shape": ("profile_encode", [_VP, _VP]),
    # gpuar_probe_scalar(seed, n, steps, probe, out, stream)
    "gpuar_probe_scalar": ("probe_layouts", [_VP, _I32, _I32, _I32, _VP,
                                             _VP]),
    # gpuar_probe_table(n, steps, probe, tables, acc, stream)
    "gpuar_probe_table": ("probe_layouts", [_I32, _I32, _I32, _VP, _VP,
                                            _VP]),
    # gpuar_probe_table_shape(*threads, *smem_bytes)
    "gpuar_probe_table_shape": ("probe_layouts", [_VP, _VP]),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# What nvcc printed for each library built in this process (with -v,
# ptxas's registers, stack and spills of every kernel), by source stem.
BUILD_LOGS: dict[str, str] = {}

# Kernel launches through the wrappers, by kernel: K1, G1 (the body
# gather after K1), K2 (release decode) and K3 (debug decode).
LAUNCHES = {"encode": 0, "gather": 0, "decode": 0, "decode_debug": 0}
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


def sources() -> list[Path]:
    """Every kernel source, one library each."""
    return sorted(p for p in _CSRC.iterdir() if p.suffix == ".cu")


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


def library_path(source: Path) -> Path:
    h = hashlib.sha256()
    for p in [source, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build(stems: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all) into their cached
    libraries, one ``nvcc`` process per missing library, all started
    together -> {stem: library path}."""
    chosen = [p for p in sources() if stems is None or p.stem in stems]
    outs = {p.stem: library_path(p) for p in chosen}
    todo = [p for p in chosen if not outs[p.stem].exists()]
    if not todo:
        return outs
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for src in todo:
        out = outs[src.stem]
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src.stem, cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for stem, cmd, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOGS[stem] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def _bind(stem: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (src, argtypes) in SIGNATURES.items():
        if src == stem:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I32
    return lib


def load(stems: list[str] | None = None) -> dict[str, ctypes.CDLL]:
    """Build (all at once) and load the named libraries (default: all)."""
    with _LOCK:
        want = [p.stem for p in sources() if stems is None or p.stem in stems]
        missing = [s for s in want if s not in _LIBS]
        if missing:
            for stem, path in build(missing).items():
                _LIBS[stem] = _bind(stem, path)
        return {s: _LIBS[s] for s in want}


def function(name: str):
    """The C entry point ``name``, its library built and loaded first."""
    stem = SIGNATURES[name][0]
    lib = _LIBS.get(stem) or load([stem])[stem]
    return getattr(lib, name)


def launch_shape(entry: str, *args) -> tuple[int, int]:
    """(threads, dynamic shared memory bytes) per block of a kernel's
    launch, as its shape entry point ``entry`` reports them for ``args``."""
    vals = [ctypes.c_int() for _ in range(2)]
    check(function(entry)(*args, *(ctypes.byref(v) for v in vals)), entry)
    return vals[0].value, vals[1].value


def blocks_per_sm() -> int:
    """How many blocks of the codec kernels' launch (K1, K2 and K3, whose
    blocks are alike) one SM of the current device holds at once: the
    least of their occupancies, as the CUDA runtime computes them."""
    counts = []
    for entry in ("gpuar_encode_occupancy", "gpuar_decode_occupancy"):
        held = ctypes.c_int()
        check(function(entry)(ctypes.byref(held)), entry)
        counts.append(held.value)
    return min(counts)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}")
