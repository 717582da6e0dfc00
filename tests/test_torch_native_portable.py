"""Portable-build differential test for the port's golden codec
(``gpuar_tpu_torch/native/golden.cpp``), mirroring the JAX package's
``tests/test_native_portable.py`` for its own copy.

The port builds its copy with ``-march=native``, which on an AVX-512BW
host takes the intrinsics paths (mask-popcount decode pass, masked bump,
span magic tables) behind ``#if defined(__AVX512BW__)`` and ``TG_NO_*``
guards.  A host without AVX-512 takes the portable loops instead, so
those are built here and held to the default build:

  * base  — ``-march=x86-64`` (no AVX-512 macros defined);
  * noopt — the native ISA with every ``TG_NO_*`` opt-out defined, so the
            portable code runs even where the ISA would allow intrinsics.

Each arm's encode must equal the default build's bit for bit, it must
decode the default build's packets, and its ``tg_splice_at`` must splice
a row-aligned blob in place to the same body.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import pytest

from gpuar_tpu_torch import native
from gpuar_tpu_torch.config import (
    COMPRESSED_PACKET_SIZE as CPS,
    UNCOMPRESSED_PACKET_SIZE as UPS,
)

_ARMS = {
    "base": ["-march=x86-64"],
    "noopt": ["-march=native", "-DTG_NO_HULL", "-DTG_NO_MASKPOP",
              "-DTG_NO_MASKPOP_BUMP", "-DTG_NO_SPAN_MAGIC"],
}

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _build_arm(name: str, flags: list[str]):
    """The arm's library in the port's build directory, keyed by the
    source and the flags; a per-pid temporary name, renamed into place."""
    src = native._SRC
    tag = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = native._BUILD_DIR / f"libgpuar_golden_{name}_{tag}.so"
    if out.exists():
        return out
    native._BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(
        ["g++", "-std=c++17", "-O3", *flags, "-fPIC", "-shared", str(src),
         "-o", str(tmp)], check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def _load_arm(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.tg_encode_packet.argtypes = [_U8P, ctypes.c_int, _U8P]
    lib.tg_encode_packet.restype = ctypes.c_int
    lib.tg_decode_packet.argtypes = [_U8P, _U8P]
    lib.tg_decode_packet.restype = ctypes.c_int
    i64p, i32p, long_ = (ctypes.POINTER(ctypes.c_long),
                         ctypes.POINTER(ctypes.c_int32), ctypes.c_long)
    lib.tg_splice_at.argtypes = [_U8P, long_, i64p, i32p, long_, _U8P,
                                 long_]
    lib.tg_splice_at.restype = long_
    return lib


def _enc(lib, data: np.ndarray) -> np.ndarray:
    out = np.zeros(CPS, np.uint8)
    n = lib.tg_encode_packet(
        data.ctypes.data_as(_U8P), len(data), out.ctypes.data_as(_U8P))
    return out[:n].copy()


def _dec(lib, comp: np.ndarray) -> np.ndarray:
    buf = np.zeros(CPS, np.uint8)
    buf[:len(comp)] = comp
    out = np.zeros(UPS, np.uint8)
    n = lib.tg_decode_packet(
        buf.ctypes.data_as(_U8P), out.ctypes.data_as(_U8P))
    return out[:n].copy()


def _cases(rng) -> list[np.ndarray]:
    """Boundary sizes, skewed alphabets with high-byte injections (the
    hull's tail) and a ramp: the JAX test's case mix."""
    cases = []
    for size in (UPS, UPS - 1, 1, 17, UPS // 2 + 3):
        cases.append(rng.integers(0, 256, size, dtype=np.uint8))
        cases.append(np.zeros(size, np.uint8))
        cases.append(rng.integers(0, 8, size, dtype=np.uint8))
    for _ in range(24):
        size = int(rng.integers(1, UPS + 1))
        alpha = int(rng.integers(2, 257))
        probs = rng.dirichlet(np.full(alpha, 0.2))
        syms = rng.choice(alpha, size=size, p=probs).astype(np.uint8)
        if rng.random() < 0.4:
            k = int(rng.integers(1, 9))
            syms[rng.integers(0, size, k)] = rng.integers(
                200, 256, k).astype(np.uint8)
        cases.append(syms)
    cases.append(np.arange(UPS, dtype=np.uint32).astype(np.uint8))
    return cases


@pytest.mark.parametrize("arm", sorted(_ARMS))
def test_portable_build_bit_equal(arm):
    lib = _load_arm(_build_arm(arm, _ARMS[arm]))
    default = native.load()
    rng = np.random.default_rng(0xA11CE)
    packets = []
    for i, data in enumerate(_cases(rng)):
        ref = _enc(default, data)
        got = _enc(lib, data)
        assert np.array_equal(got, ref), \
            f"arm {arm}: encode bitstream differs on case {i} " \
            f"(size {len(data)})"
        back = _dec(lib, ref)
        assert np.array_equal(back, data), \
            f"arm {arm}: decode mismatch on case {i} (size {len(data)})"
        packets.append(ref)

    lengths = np.array([p.size for p in packets], np.int32)
    rows = -(-lengths // 96)
    offsets = np.zeros(len(packets), np.int64)
    np.cumsum(rows[:-1] * 96, out=offsets[1:])
    blob = np.full(int(offsets[-1] + rows[-1] * 96), 0xFF, np.uint8)
    for off, p in zip(offsets, packets):
        blob[off: off + p.size] = p
    w = lib.tg_splice_at(blob.ctypes.data_as(_U8P), blob.size,
                         offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                         lengths.ctypes.data_as(
                             ctypes.POINTER(ctypes.c_int32)),
                         len(packets), blob.ctypes.data_as(_U8P), blob.size)
    assert w == lengths.sum()
    assert blob[:w].tobytes() == b"".join(p.tobytes() for p in packets), \
        f"arm {arm}: in-place splice differs"
