"""GPUCompressor: the GPU-backed file pipeline.

The counterpart of ``gpuar_tpu/parallel/runner.py::TPUCompressor``: it
plugs a MeshCodec over the local GPUs (every one by default, or the one
``device_index`` pins) into the shared drive loops of
``gpuar_tpu.pipeline.Compressor`` (read a super-batch, submit it, fetch the
previous one, splice in order into the ``.gip`` container).  Each device's
CUDA streams and per-batch events let batch N+1 run on the cards while the
host writes batch N.  In a ``--multihost`` run each process's
GPUCompressor codes that process's range on its own local GPUs
(``parallel/distributed.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from gpuar_tpu.pipeline import Compressor, DEFAULT_SUPER_BATCH_PACKETS
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
        # The super-batch is the total over all devices (no lane rounding).
        super().__init__(super_batch_packets=super_batch_packets)

    def _packetize(self, raw: np.ndarray):
        psize = self.packet_size
        n = -(-raw.size // psize)
        if n == 0:
            return None, None
        sizes = np.full(n, psize, np.int32)
        if raw.size == n * psize:
            # Whole batches need no padding: a view (the codec copies it
            # into its pinned upload buffer).
            return raw.reshape(n, psize), sizes
        data = np.zeros((n, psize), np.uint8)
        data.reshape(-1)[: raw.size] = raw
        sizes[-1] = raw.size - (n - 1) * psize
        return data, sizes

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
    # straight from its block buffer and K2 reads it in place.
    def decode_blob_geometry(self):
        return self.codec.row_bytes, BUCKET_ROWS

    def decode_submit_blob(self, blob, roff, comp_len, raw_sizes,
                           hull_hint=None):
        return self.codec.decode_blob_async(blob, roff, comp_len, raw_sizes)

    def decode_fetch(self, handle):
        return self.codec.decode_body_wait(handle)
