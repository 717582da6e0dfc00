"""Sleep-codec control backend for the weak-scaling harness (the port's
copy of ``benchmarks/sleep_backend.py``, on the port's ``Compressor``).

On one shared machine, N ranks that each burn the CPU or share one card
serialise inside the codec section, so the measured ``wall_efficiency``
shows the sharing, not the design.  This control removes the contention
without removing the thing under test: a fake backend that *sleeps* the
per-batch device time (bytes / a measured card GB/s) instead of computing,
while the real ``DistributedCompressor`` machinery — the torch.distributed
(gloo) collectives, barriers, size all-gather, offset scan, parallel
splice at offsets, real file I/O — runs unchanged.  N sleeping ranks do
not contend, so ``wall_efficiency`` directly measures the design's
coordination cost.

The emitted packets use the real container framing ([u16 total][u16 raw]
+ body, gpuar_tpu_torch/container.py; reference
src/gpuar_kernel.cu:527-528) with a *stored* body, so the size all-gather,
exclusive-scan offsets and splice writes all see realistic per-packet
sizes; the archive is framed validly but its bitstreams are not decodable
(this backend is a measurement control, not a codec).
"""

import time

import numpy as np

from gpuar_tpu_torch.config import (
    COMPRESSED_PACKET_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)
from gpuar_tpu_torch.pipeline import Compressor, DEFAULT_SUPER_BATCH_PACKETS


class SleepCompressor(Compressor):
    """Emulates a device codec at ``gbps`` by sleeping, asynchronously:
    ``encode_submit`` stamps a deadline (device compute runs in the
    background, like GPUCompressor's async submit), ``encode_fetch``
    sleeps out the remainder — so host I/O overlap behaves exactly like
    the real device pipeline."""

    def __init__(self, gbps: float, time_scale: float = 1.0,
                 super_batch_packets: int = DEFAULT_SUPER_BATCH_PACKETS):
        super().__init__(super_batch_packets=super_batch_packets)
        self.gbps = float(gbps)
        # time_scale > 1 emulates a larger device payload than the bytes
        # moved (scaling.py --emulate-gib): the device time scales with the
        # emulated payload while the coordination metadata does not, so a
        # small real body keeps its byte-moving CPU out of the measurement.
        self.time_scale = float(time_scale)
        # A real device serializes submitted batches: submit-ahead hides
        # HOST time behind device compute, it does not double device
        # throughput.  Deadlines therefore chain off a device-busy cursor
        # (two in-flight batches sleeping concurrently would emulate a 2x
        # faster device and inflate whichever world size pipelines deeper).
        self._busy_until = 0.0

    def _deadline(self, nbytes: int) -> float:
        start = max(time.perf_counter(), self._busy_until)
        self._busy_until = start + (
            nbytes * self.time_scale / (self.gbps * 1e9))
        return self._busy_until

    # --- encode -------------------------------------------------------------
    def encode_submit(self, raw: np.ndarray):
        return (self._deadline(raw.size), np.asarray(raw, np.uint8))

    def encode_fetch(self, handle):
        # Vectorized (no per-packet Python loop: 8k small-op iterations per
        # super-batch would burn the very CPU this control removes).
        deadline, raw = handle
        psize = UNCOMPRESSED_PACKET_SIZE
        n = -(-raw.size // psize) if raw.size else 0
        packets = np.zeros((n, COMPRESSED_PACKET_SIZE), np.uint8)
        lengths = np.zeros(n, np.int32)
        if n:
            raw_sizes = np.full(n, psize, np.int64)
            raw_sizes[-1] = raw.size - (n - 1) * psize
            padded = np.zeros(n * psize, np.uint8)
            padded[: raw.size] = raw
            packets[:, 4: 4 + psize] = padded.reshape(n, psize)
            lengths[:] = PACKET_HEADER_LENGTH + raw_sizes
            hdr = np.zeros((n, 2), np.uint16)  # LE layout, like the container
            hdr[:, 0] = lengths
            hdr[:, 1] = raw_sizes
            packets[:, :4] = hdr.view(np.uint8)
        rest = deadline - time.perf_counter()
        if rest > 0:
            time.sleep(rest)
        return packets, lengths

    # --- decode -------------------------------------------------------------
    def decode_submit(self, packets: np.ndarray, raw_sizes: np.ndarray):
        return (self._deadline(int(np.sum(raw_sizes))),
                np.asarray(packets, np.uint8),
                np.asarray(raw_sizes, np.int64))

    def decode_fetch(self, handle):
        deadline, packets, raw_sizes = handle
        psize = UNCOMPRESSED_PACKET_SIZE
        out = packets[:, 4: 4 + psize].copy()
        # Zero any bytes past each packet's raw size (stored bodies are
        # already zero-padded on encode, but incoming archives need not be).
        mask = np.arange(psize)[None, :] >= np.asarray(raw_sizes)[:, None]
        out[mask] = 0
        rest = deadline - time.perf_counter()
        if rest > 0:
            time.sleep(rest)
        return out
