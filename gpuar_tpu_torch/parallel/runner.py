"""GPUCompressor: the GPU-backed file pipeline.

The counterpart of ``gpuar_tpu/parallel/runner.py::TPUCompressor``: it
plugs a MeshCodec over the local GPUs (every one by default, or the one
``device_index`` pins) into the drive loops of ``pipeline.Compressor``
(read a super-batch into the mesh's pinned upload buffer, submit it,
fetch the previous one's body, gathered on the cards, and write it in
order into the ``.gip`` container).
Each device's CUDA streams and per-batch events let batch N+1 run on the
cards while the host writes batch N.  In a ``--multihost`` run each process's
GPUCompressor codes that process's range on its own local GPUs
(``parallel/distributed.py``).

The super-batch, which is also each card's kernel launch, is sized from
the cards, as the reference sizes its batches from the SM count
(src/gpu_compressor.cpp:77-79): ``card_batch_packets``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpuar_tpu_torch.pipeline import Compressor, DEFAULT_SUPER_BATCH_PACKETS
from gpuar_tpu_torch.parallel.mesh import MeshCodec

# A card's batch in waves of the codec kernels' launch, a wave being as
# many blocks as the card holds at once (SMs x blocks an SM): a quarter
# wave, on the H100 (132 SMs, 2 blocks of 64 threads an SM) half a block
# an SM, 4224 packets.  Chosen by ``chip_smoke.py --sweep`` over the
# benchmark cells' corpora, against 8192 and sizes of 1/16 to 2 waves
# (PERF.md section 6).
BATCH_WAVES = 0.25


def launch_geometry(device: torch.device) -> tuple[int, int, int] | None:
    """(SMs, blocks per SM, threads per block) of the codec kernels'
    launch on a CUDA device: the SMs from the device's properties, the
    blocks from the CUDA runtime's occupancy of K1, K2 and K3 (built first
    if need be), the threads from their launch.  None off the card."""
    if device.type != "cuda":
        return None
    from gpuar_tpu_torch.ops import _kernels

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        threads, _ = _kernels.launch_shape("gpuar_decode_shape")
        blocks = _kernels.blocks_per_sm()
    return sms, blocks, threads


def batch_packets(geometry: tuple[int, int, int],
                  waves: float = BATCH_WAVES) -> int:
    """Packets of one card's batch of ``waves`` waves: ceil(f x SMs)
    whole blocks, f = waves x blocks per SM, of one packet a thread."""
    sms, blocks, threads = geometry
    return math.ceil(waves * blocks * sms) * threads


def card_batch_packets(devices: list[torch.device]) -> int | None:
    """The super-batch over ``devices`` from their cards: one card's batch
    (``batch_packets``; the least, where the cards differ) times the
    number of devices, which MeshCodec splits evenly.  None where a device
    is not a CUDA device."""
    geometries = [launch_geometry(d) for d in devices]
    if None in geometries:
        return None
    return len(devices) * min(batch_packets(g) for g in geometries)


class GPUCompressor(Compressor):
    """``super_batch_packets``: packets a super-batch over all devices; by
    default ``card_batch_packets(devices)`` (``batch_from_card`` is then
    true), or DEFAULT_SUPER_BATCH_PACKETS on CPU devices."""

    def __init__(self, device_index: int | None = None,
                 super_batch_packets: int | None = None,
                 debug: bool = False, packet_size: int | None = None,
                 devices: list[torch.device] | None = None):
        # devices: explicit torch devices, one shard each (one card may be
        # named twice); only the tests and chip_smoke.py pass them (the CPU
        # runs the kernels' plain versions).  By default the codec runs on
        # cuda:0 .. cuda:{count-1}, or on cuda:{device_index} alone, and
        # there is no fallback.
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available")
            count = torch.cuda.device_count()
            if device_index is None:
                devices = [torch.device("cuda", i) for i in range(count)]
            elif 0 <= device_index < count:
                devices = [torch.device("cuda", device_index)]
            else:
                raise ValueError(f"no device {device_index}")
        # debug: decompress through K3 (coder invariants + bitstream
        # overrun), so corrupt well-framed packets raise.
        kw = {} if packet_size is None else {"packet_size": packet_size}
        self.codec = MeshCodec(devices, debug=debug, **kw)
        self.packet_size = self.codec.packet_size
        self._handed = None  # the last encode_buffer, until encode_submit
        self.batch_from_card = False
        if super_batch_packets is None:
            super_batch_packets = card_batch_packets(devices)
            self.batch_from_card = super_batch_packets is not None
        if super_batch_packets is None:
            super_batch_packets = DEFAULT_SUPER_BATCH_PACKETS
        # The super-batch is the total over all devices (no lane rounding).
        super().__init__(super_batch_packets=super_batch_packets)

    def encode_buffer(self, nbytes: int) -> np.ndarray:
        """The flat host buffer to read the next super-batch's nbytes into:
        the mesh's data buffer (``MeshCodec.encode_buffer``) of whole
        packets, pinned for a CUDA device, so the upload reads the file's
        bytes where they were read."""
        n = -(-nbytes // self.packet_size)
        self._handed = self.codec.encode_buffer(n).reshape(-1)
        return self._handed

    def _packetize(self, raw: np.ndarray):
        psize = self.packet_size
        n = -(-raw.size // psize)
        if n == 0:
            return None, None
        buf, self._handed = self._handed, None
        if buf is None or raw.ctypes.data != buf.ctypes.data:
            # Not read into encode_buffer (encode_batch's callers): one
            # copy into the upload buffer.
            buf = self.codec.encode_buffer(n).reshape(-1)
            buf[: raw.size] = raw
        # The ragged last packet's tail, zeroed in place: a reused buffer
        # still holds an earlier batch's bytes there.
        buf[raw.size: n * psize] = 0
        sizes = np.full(n, psize, np.int32)
        sizes[-1] = raw.size - (n - 1) * psize
        return buf[: n * psize].reshape(n, psize), sizes

    def encode_batch(self, raw: np.ndarray):
        return self.encode_fetch(self.encode_submit(raw))

    def decode_batch(self, packets: np.ndarray, raw_sizes: np.ndarray):
        return self.decode_fetch(self.decode_submit(packets, raw_sizes))

    # Async interface of the drive loops: submit launches, fetch waits.
    def encode_submit(self, raw: np.ndarray):
        data, sizes = self._packetize(raw)
        if data is None:
            return None
        return self.codec.encode_body_async(data, sizes)

    def encode_fetch(self, handle):
        if handle is None:
            return np.zeros((0, 1), np.uint8), np.zeros(0, np.int32)
        return self.codec.encode_body_wait(handle)

    def decode_submit(self, packets: np.ndarray, raw_sizes: np.ndarray):
        return self.codec.decode_async(packets, raw_sizes)

    # Dense upload: the packet reader reads each batch's packets, as they
    # lie in the file, into the pinned buffer the upload reads, and K2
    # reads them in place at their byte offsets.
    def decode_blob_buffer(self, nbytes: int):
        return self.codec.blob_buffer(nbytes)

    def decode_submit_blob(self, blob, offsets, comp_len, raw_sizes):
        return self.codec.decode_blob_async(blob, offsets, comp_len,
                                            raw_sizes)

    def decode_fetch(self, handle):
        return self.codec.decode_body_wait(handle)
