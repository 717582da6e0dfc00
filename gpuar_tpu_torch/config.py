"""Codec configuration constants (the port's copy of ``gpuar_tpu/config.py``).

These mirror the compile-time configuration of the reference implementation
(jiahansu/GPUAR: src/gpu.h:8-14 and src/gpuar.h:20-40) so that the bitstreams
and the .gip container produced here are interchangeable with the reference.

The two validation rules enforced at construction reproduce the reference's
startup checks (src/compressor.cpp:8-16):
  * the uncompressed packet size must be a multiple of the 16-byte read
    element (the reference reads input as ``ulonglong2``), and
  * the packet must be small enough that the adaptive model's cumulative
    probability can never reach MAX_PROBABILITY (no rescaling path exists).
"""

from __future__ import annotations

import dataclasses

# --- coder precision (src/gpuar.h:32-40) ---------------------------------
PRECISION = 16                      # bits of coder state (u16 lower/upper)
MAX_PROBABILITY = 1 << (PRECISION - 2)   # 16384: keeps lower/upper ordered
EOF_CHAR = 255                      # reserved symbol slot (never coded)
NUM_SYMBOLS = 256                   # byte alphabet
MODEL_SIZE = NUM_SYMBOLS + 1        # cumulative-frequency entries 0..256

MSB_MASK = 1 << (PRECISION - 1)     # MASK_BIT(0) = 0x8000
SECOND_MASK = 1 << (PRECISION - 2)  # MASK_BIT(1) = 0x4000
U16_MASK = (1 << PRECISION) - 1     # 0xFFFF

INITIAL_CUMULATIVE_PROB = NUM_SYMBOLS   # 256: every symbol starts at count 1

# --- packet geometry (src/gpu.h:8-14) -------------------------------------
EXTRA_COMPRESSED_SIZE = 512
UNCOMPRESSED_PACKET_SIZE = 8192
COMPRESSED_PACKET_SIZE = UNCOMPRESSED_PACKET_SIZE + EXTRA_COMPRESSED_SIZE  # 8704
PACKET_HEADER_LENGTH = 4            # [u16 LE total size][u16 LE raw size]
READ_ELEMENT_SIZE = 16              # sizeof(ulonglong2)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Frozen codec geometry. Defaults reproduce the reference exactly."""

    uncompressed_packet_size: int = UNCOMPRESSED_PACKET_SIZE
    extra_compressed_size: int = EXTRA_COMPRESSED_SIZE
    packet_header_length: int = PACKET_HEADER_LENGTH
    precision: int = PRECISION

    def __post_init__(self) -> None:
        if self.precision != 16:
            raise ValueError("only 16-bit coder precision is supported")
        if self.uncompressed_packet_size % READ_ELEMENT_SIZE != 0:
            raise ValueError(
                "uncompressed packet size must be a multiple of the "
                f"{READ_ELEMENT_SIZE}-byte read element"
            )
        # src/compressor.cpp:13: packet size must keep cumulativeProb below
        # MAX_PROBABILITY (initial 256 + one increment per coded symbol).
        if self.uncompressed_packet_size >= MAX_PROBABILITY - MODEL_SIZE:
            raise ValueError(
                "packet size too large: adaptive model would overflow "
                "MAX_PROBABILITY (no rescaling path exists)"
            )
        if self.uncompressed_packet_size > 0xFFFF - self.extra_compressed_size:
            raise ValueError("packet sizes must fit the u16 header fields")

    @property
    def compressed_packet_size(self) -> int:
        return self.uncompressed_packet_size + self.extra_compressed_size

    @property
    def max_cumulative_prob(self) -> int:
        return INITIAL_CUMULATIVE_PROB + self.uncompressed_packet_size


DEFAULT_CONFIG = CodecConfig()
