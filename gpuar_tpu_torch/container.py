"""The .gip container format (the port's copy of ``gpuar_tpu/container.py``,
with its own ``ContainerError``).

Byte layout identical to the reference (jiahansu/GPUAR src/file_header.hpp):

    offset 0..2   version bytes (0, 1, 0)
    offset 3      reserved (reference leaves it uninitialised; we zero it)
    offset 4      uncompressed file size, LE (reference writes u32 at :61-66)
    offset 12     compressed file size incl. this header, LE (:67-72)
    offset 20     packets: [u16 total size][u16 raw size][AC bitstream] ...

The layout reserves 8 bytes for each size field (offsets 4 and 12, see
HEADER_LENGTH arithmetic at src/file_header.hpp:20-22) but the reference
only ever writes the low 4 bytes and leaves the rest uninitialised; its
reader ignores them (:48-59).  We write the full 64-bit little-endian value
into each slot — for files under 4 GiB that is byte-identical to the
reference plus zeroed garbage, and it lifts the 4 GiB file-size limit the
reference has (SURVEY.md §7.5).  When reading, a reference-written file is
detected by garbage in the high halves and falls back to the u32 fields.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator

from gpuar_tpu_torch.config import (
    COMPRESSED_PACKET_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)

VERSION = (0, 1, 0)
HEADER_LENGTH = 20


class ContainerError(ValueError):
    """Malformed .gip input."""


@dataclasses.dataclass
class FileHeader:
    uncompressed_size: int = 0
    compressed_size: int = 0  # includes the 20-byte header

    def to_bytes(self) -> bytes:
        return struct.pack(
            "<BBBBQQ",
            VERSION[0],
            VERSION[1],
            VERSION[2],
            0,
            self.uncompressed_size,
            self.compressed_size,
        )

    @classmethod
    def from_bytes(cls, raw: bytes, actual_file_size: int | None = None) -> "FileHeader":
        if len(raw) < HEADER_LENGTH:
            raise ContainerError("Incorrect file format: truncated header")
        major, minor, rev = raw[0], raw[1], raw[2]
        if (major, minor, rev) != VERSION:
            raise ContainerError(
                f"Incorrect file format: unsupported version {major}.{minor}.{rev}"
            )
        usize64, csize64 = struct.unpack_from("<QQ", raw, 4)
        usize32 = usize64 & 0xFFFFFFFF
        csize32 = csize64 & 0xFFFFFFFF
        # Reference-written files carry uninitialised bytes in the high
        # halves; trust the u64s only when they are consistent.
        if actual_file_size is not None and csize64 != actual_file_size:
            if csize32 <= actual_file_size:
                return cls(uncompressed_size=usize32, compressed_size=csize32)
        return cls(uncompressed_size=usize64, compressed_size=csize64)


def packet_sizes(header4: bytes) -> tuple[int, int]:
    """(total packet bytes incl. 4-byte header, raw uncompressed bytes).

    Mirrors getCompressedSize/getUncompressedSize (src/gpuar_kernel.cu:36-46).
    """
    total, raw = struct.unpack_from("<HH", header4, 0)
    return total, raw


def validate_packet_header(total: int, raw: int, max_raw: int) -> None:
    if total < PACKET_HEADER_LENGTH or total > COMPRESSED_PACKET_SIZE:
        raise ContainerError(f"Incorrect file format: packet size {total} out of range")
    if raw > max_raw:
        raise ContainerError(f"Incorrect file format: raw size {raw} exceeds packet size")


def read_packets(stream: BinaryIO, max_raw: int | None = None) -> Iterator[bytes]:
    """Yield complete packets (header + bitstream) from a .gip body."""
    max_raw = UNCOMPRESSED_PACKET_SIZE if max_raw is None else max_raw
    while True:
        head = stream.read(PACKET_HEADER_LENGTH)
        if not head:
            return
        if len(head) < PACKET_HEADER_LENGTH:
            raise ContainerError("Incorrect file format: truncated packet header")
        total, raw = packet_sizes(head)
        validate_packet_header(total, raw, max_raw=max_raw)
        body = stream.read(total - PACKET_HEADER_LENGTH)
        if len(body) < total - PACKET_HEADER_LENGTH:
            raise ContainerError("Incorrect file format: truncated packet body")
        yield head + body
