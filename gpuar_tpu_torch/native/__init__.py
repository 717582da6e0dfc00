"""The native golden codec (``golden.cpp``, the port's copy of
``gpuar_tpu/native/golden.cpp``), built with g++ and loaded with ctypes.

It is the port's ``--host`` codec (``pipeline.HostCompressor``), the deep
check of ``verify_archive``, the host splice of the GPU path
(``splice_at``, ``expand_at``), the decode reader's packet walk
(``walk_packets``) and the stream codec of whole ``.gip``
bodies (``encode_stream``, ``decode_stream``).  The library is compiled
at first use into ``gpuar_tpu_torch/_build/`` (git-ignored), keyed by a
hash of the source, so an edit rebuilds it.  Each build writes a
temporary file named by its process id and renames it into place, so
processes that build at once (test workers in a fresh checkout) never see
one another's half-written library.

Every entry point of the JAX package's loader is bound, under its name;
``walk_packets`` and ``expand_at``'s ``out=`` are the port's own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from gpuar_tpu_torch.config import (
    COMPRESSED_PACKET_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)

_SRC = Path(__file__).with_name("golden.cpp")
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

GXX_FLAGS = ["-std=c++17", "-O3", "-march=native", "-fPIC", "-shared"]


def library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libgpuar_golden_{tag}.so"


def build() -> Path:
    """Compile golden.cpp into the cached library (no-op when it exists)."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_long)
            long_ = ctypes.c_long
            lib.tg_encode_packet.argtypes = [u8p, ctypes.c_int, u8p]
            lib.tg_encode_packet.restype = ctypes.c_int
            lib.tg_decode_packet.argtypes = [u8p, u8p]
            lib.tg_decode_packet.restype = ctypes.c_int
            lib.tg_decode_packet_delta.argtypes = [u8p, u8p]
            lib.tg_decode_packet_delta.restype = long_
            lib.tg_encode_batch.argtypes = [u8p, long_, ctypes.c_int, u8p,
                                            long_, i32p]
            lib.tg_encode_batch.restype = long_
            lib.tg_decode_batch.argtypes = [u8p, long_, long_, u8p, long_,
                                            i32p]
            lib.tg_decode_batch.restype = None
            lib.tg_encode_stream.argtypes = [u8p, long_, ctypes.c_int, u8p,
                                             long_]
            lib.tg_encode_stream.restype = long_
            lib.tg_decode_stream.argtypes = [u8p, long_, u8p, long_]
            lib.tg_decode_stream.restype = long_
            lib.tg_splice.argtypes = [u8p, long_, i32p, long_, u8p, long_]
            lib.tg_splice.restype = long_
            lib.tg_splice_at.argtypes = [u8p, long_, i64p, i32p, long_, u8p,
                                         long_]
            lib.tg_splice_at.restype = long_
            lib.tg_expand_at.argtypes = [u8p, long_, i64p, i32p, long_, u8p,
                                         long_]
            lib.tg_expand_at.restype = long_
            vp = ctypes.c_void_p
            lib.tg_walk_packets.argtypes = [vp, long_, long_, ctypes.c_int,
                                            ctypes.c_int, vp, long_, long_,
                                            long_, vp, vp, vp, vp]
            lib.tg_walk_packets.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def encode_packet(data: bytes) -> bytes:
    """One framed packet ``[u16 LE total][u16 LE raw][bitstream]``."""
    lib = load()
    src = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    out = np.empty(len(data) + 512 + PACKET_HEADER_LENGTH + 16,
                   dtype=np.uint8)
    n = lib.tg_encode_packet(_u8p(src), len(data), _u8p(out))
    return out[:n].tobytes()


def decode_packet(packet: bytes) -> bytes:
    lib = load()
    src = np.ascontiguousarray(np.frombuffer(packet, dtype=np.uint8))
    raw = packet[2] | (packet[3] << 8)
    out = np.empty(max(raw, 1), dtype=np.uint8)
    n = lib.tg_decode_packet(_u8p(src), _u8p(out))
    return out[:n].tobytes()


def decode_packet_delta(packet: bytes) -> tuple[bytes, int]:
    """(decoded bytes, bit-consumption delta vs the framed body length).

    A delta beyond +16 bits of lookahead marks a corrupt well-framed
    packet (the host mirror of K3's overrun flag,
    ``ops.decode.check_debug_flags``)."""
    lib = load()
    src = np.ascontiguousarray(np.frombuffer(packet, dtype=np.uint8))
    raw = packet[2] | (packet[3] << 8)
    out = np.empty(max(raw, 1), dtype=np.uint8)
    delta = lib.tg_decode_packet_delta(_u8p(src), _u8p(out))
    return out[:raw].tobytes(), int(delta)


def encode_batch(data: np.ndarray, packet_size: int = UNCOMPRESSED_PACKET_SIZE,
                 out_stride: int = COMPRESSED_PACKET_SIZE):
    """Raw bytes -> (packets [n, out_stride] uint8, lengths [n] int32)."""
    lib = load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = max(1, -(-data.size // packet_size)) if data.size else 0
    out = np.zeros((max(n, 1), out_stride), dtype=np.uint8)
    lengths = np.zeros(max(n, 1), dtype=np.int32)
    count = lib.tg_encode_batch(_u8p(data), data.size, packet_size, _u8p(out),
                                out_stride, _i32p(lengths))
    return out[:count], lengths[:count]


def decode_batch(packets: np.ndarray,
                 out_stride: int = UNCOMPRESSED_PACKET_SIZE):
    """Fixed-stride packets [n, stride] -> (raw [n, out_stride], lengths)."""
    lib = load()
    packets = np.ascontiguousarray(packets, dtype=np.uint8)
    n = packets.shape[0]
    out = np.zeros((max(n, 1), out_stride), dtype=np.uint8)
    lengths = np.zeros(max(n, 1), dtype=np.int32)
    lib.tg_decode_batch(_u8p(packets), packets.shape[1], n, _u8p(out),
                        out_stride, _i32p(lengths))
    return out[:n], lengths[:n]


def encode_stream(data: np.ndarray | bytes,
                  packet_size: int = UNCOMPRESSED_PACKET_SIZE) -> bytes:
    """Raw bytes -> a back-to-back .gip packet body."""
    lib = load()
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    # Room for every packet's worst case: its bytes, 512 of coder
    # overhead and its header.
    npackets = -(-max(data.size, 1) // packet_size)
    cap = data.size + npackets * (512 + PACKET_HEADER_LENGTH) + 64
    out = np.empty(cap, dtype=np.uint8)
    w = lib.tg_encode_stream(_u8p(data), data.size, packet_size, _u8p(out),
                             cap)
    if w < 0:
        raise RuntimeError("native encode_stream overflow")
    return out[:w].tobytes()


def decode_stream(body: np.ndarray | bytes, out_cap: int) -> bytes:
    """A back-to-back .gip packet body -> its raw bytes (at most
    ``out_cap``)."""
    lib = load()
    if isinstance(body, (bytes, bytearray, memoryview)):
        body = np.frombuffer(bytes(body), dtype=np.uint8)
    body = np.ascontiguousarray(body, dtype=np.uint8)
    out = np.empty(max(out_cap, 1), dtype=np.uint8)
    w = lib.tg_decode_stream(_u8p(body), body.size, _u8p(out), out.size)
    if w == -1:
        raise ValueError("Incorrect file format: malformed packet framing")
    if w == -2:
        raise ValueError("decode output overflow")
    return out[:w].tobytes()


def splice(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate rows[i, :lengths[i]] (a native memcpy loop) -> uint8."""
    lib = load()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    if rows.ndim != 2 or lengths.shape[0] != rows.shape[0]:
        raise ValueError("rows [n, stride] and lengths [n] required")
    out = np.empty(int(lengths.sum()), dtype=np.uint8)
    w = lib.tg_splice(_u8p(rows), rows.shape[1], _i32p(lengths),
                      rows.shape[0], _u8p(out), out.size)
    if w < 0:
        raise ValueError("splice: length exceeds row stride")
    return out[:w]


def splice_at(blob: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              out: np.ndarray | None = None) -> np.ndarray:
    """Concatenate blob[offsets[i] : offsets[i]+lengths[i]]: strips the
    row padding of a device-compacted encode blob -> uint8.

    ``out``: a flat C-contiguous uint8 array to splice into (default a
    new one); the result is a view of its head.  It may be ``blob``
    itself: in place, every packet's output must start at or before its
    source, as it does in a blob of packets laid out in order."""
    lib = load()
    blob = np.ascontiguousarray(blob, dtype=np.uint8).reshape(-1)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    total = int(lengths.sum())
    if out is None:
        out = np.empty(total, dtype=np.uint8)
    elif (out.dtype != np.uint8 or out.ndim != 1
          or not out.flags.c_contiguous or not out.flags.writeable
          or out.size < total):
        raise ValueError(f"splice_at: out must be a writable flat uint8 "
                         f"array of at least {total} B")
    w = lib.tg_splice_at(_u8p(blob), blob.size, _i64p(offsets),
                         _i32p(lengths), lengths.shape[0], _u8p(out),
                         out.size)
    if w < 0:
        raise ValueError("splice_at: offset/length out of range, or a "
                         "packet's output past its source in place")
    return out[:w]


def expand_at(body: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              blob_cap: int, out: np.ndarray | None = None) -> np.ndarray:
    """Scatter back-to-back packets to aligned blob offsets (the decode
    upload blob): blob[offsets[i]:+lengths[i]] = the next body bytes, the
    rest of the blob zeros; the offsets ascend without overlap.

    ``out``: a flat C-contiguous uint8 array of at least blob_cap bytes to
    build the blob in (a reused upload buffer), in place of a new one;
    the result is a view of its head.  Every byte no packet covers is
    zeroed, so the blob is the same whatever ``out`` held."""
    lib = load()
    body = np.ascontiguousarray(body, dtype=np.uint8).reshape(-1)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    if out is None:
        blob = np.empty(blob_cap, dtype=np.uint8)
    elif (out.dtype != np.uint8 or out.ndim != 1
          or not out.flags.c_contiguous or not out.flags.writeable
          or out.size < blob_cap):
        raise ValueError(f"expand_at: out must be a writable flat uint8 "
                         f"array of at least {blob_cap} B")
    else:
        blob = out[:blob_cap]
    r = lib.tg_expand_at(_u8p(body), body.size, _i64p(offsets),
                         _i32p(lengths), lengths.shape[0], _u8p(blob),
                         blob.size)
    if r < 0:
        raise ValueError("expand_at: offset/length out of range, or "
                         "offsets not ascending")
    return blob


# walk_packets' reasons to stop (tg_walk_packets' return value).
WALK_FULL, WALK_PARTIAL, WALK_BAD_HEADER, WALK_OVERFLOW = range(4)


def walk_packets(buf: np.ndarray, start: int, end: int, max_packets: int,
                 max_raw: int, dst: np.ndarray, row_bytes: int, rows0: int,
                 comp_len: np.ndarray, raw_sizes: np.ndarray, at: int,
                 roff: np.ndarray | None = None):
    """Walk the framed packets of buf[start:end] into dst, a flat uint8
    blob of row_bytes rows (no Python per packet).

    Each complete packet with a valid header (``container.
    validate_packet_header``'s rule, max_raw the backend's packet size)
    is copied to row ``rows0`` onward, the rest of its last row is zeroed,
    and its row offset (into ``roff``, if given), length and raw size are
    written at index ``at`` onward of the int32 arrays.  Stops after
    max_packets packets (WALK_FULL), at the first packet not complete in
    buf (WALK_PARTIAL) or at the first bad header (WALK_BAD_HEADER).
    Returns (stop, packets, bytes consumed, rows used).
    """
    for name, arr, dtype in (("buf", buf, np.uint8), ("dst", dst, np.uint8),
                             ("comp_len", comp_len, np.int32),
                             ("raw_sizes", raw_sizes, np.int32),
                             ("roff", roff, np.int32)):
        if arr is not None and (arr.dtype != dtype
                                or not arr.flags.c_contiguous):
            raise ValueError(f"walk_packets: {name} must be C-contiguous "
                             f"{np.dtype(dtype).name}")
    if not 0 <= start <= end <= buf.size:
        raise ValueError("walk_packets: start/end out of range")
    if max_packets < 0 or at < 0 or any(
            a is not None and at + max_packets > a.size
            for a in (comp_len, raw_sizes, roff)):
        raise ValueError("walk_packets: index arrays too short")
    lib = load()
    res = np.zeros(3, np.int64)
    stop = lib.tg_walk_packets(
        buf.ctypes.data + start, end - start, max_packets,
        COMPRESSED_PACKET_SIZE, max_raw, dst.ctypes.data, dst.nbytes,
        row_bytes, rows0, None if roff is None else roff.ctypes.data + 4 * at,
        comp_len.ctypes.data + 4 * at, raw_sizes.ctypes.data + 4 * at,
        res.ctypes.data)
    if stop == WALK_OVERFLOW:
        raise ValueError("walk_packets: destination too small")
    return stop, int(res[0]), int(res[1]), int(res[2])
