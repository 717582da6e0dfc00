"""GPUCompressor: the GPU-backed file pipeline.

The counterpart of ``gpuar_tpu/parallel/runner.py::TPUCompressor``: it
plugs a MeshCodec over the local GPUs (every one by default, or the one
``device_index`` pins) into the drive loops of ``pipeline.Compressor``
(read a super-batch into the mesh's pinned upload buffer, submit it,
fetch the previous one, splice in order into the ``.gip`` container).
Each device's CUDA streams and per-batch events let batch N+1 run on the
cards while the host writes batch N.  In a ``--multihost`` run each process's
GPUCompressor codes that process's range on its own local GPUs
(``parallel/distributed.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from gpuar_tpu_torch.pipeline import Compressor, DEFAULT_SUPER_BATCH_PACKETS
from gpuar_tpu_torch.parallel.codec import BUCKET_ROWS
from gpuar_tpu_torch.parallel.mesh import MeshCodec


class GPUCompressor(Compressor):
    def __init__(self, device_index: int | None = None,
                 super_batch_packets: int = DEFAULT_SUPER_BATCH_PACKETS,
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

    # Compacted upload: the packet reader builds the row-aligned blob
    # straight from its block buffer, in the pinned buffer the upload
    # reads, and K2 reads it in place.
    def decode_blob_geometry(self):
        return self.codec.row_bytes, BUCKET_ROWS

    def decode_blob_buffer(self, nbytes: int):
        return self.codec.blob_buffer(nbytes)

    def decode_submit_blob(self, blob, roff, comp_len, raw_sizes):
        return self.codec.decode_blob_async(blob, roff, comp_len, raw_sizes)

    def decode_fetch(self, handle):
        return self.codec.decode_body_wait(handle)
