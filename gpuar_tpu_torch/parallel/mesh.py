"""MeshCodec: the batch codec over several devices.

The counterpart of the multi-device part of
``gpuar_tpu/parallel/mesh.py::MeshCodec``.  JAX pads a batch to
``devices x tile`` lanes and ``shard_map`` splits the lane axis over a 1-D
mesh; here a batch of n packets is cut into contiguous shards, balanced to
within one packet, and each shard goes to the DeviceCodec of its device
(its own streams, pinned buffers and events).  Packets are independent, so
the devices never exchange data: the host splits each batch and joins the
results in packet order.

- Encode: every shard's compacted blob is downloaded into its byte range
  of one pinned batch buffer, and one ``native.splice_at`` over that
  buffer gives the batch's ``.gip`` body.
- Decode: shard k of the reader-built blob is its rows
  ``roff[a_k] .. roff[b_k]``, rebased to zero.  Every shard's output is
  downloaded straight into its rows of one pinned ``[n, packet_size]``
  batch buffer, so the host never concatenates shards; debug flags are
  joined in packet order and checked once.

One device takes the same path as several, with one shard.
What the JAX class needs and this one drops: lane padding to a quantum
(``lane_quantum``); the super-batch stays the total number of packets over
all devices.  Two entries of ``devices`` may name one card: each gets its
own DeviceCodec and streams (the CPU tests run k shards on ``[cpu] * k``).
"""

from __future__ import annotations

import numpy as np
import torch

from gpuar_tpu import native
from gpuar_tpu.config import UNCOMPRESSED_PACKET_SIZE
from gpuar_tpu_torch.ops.decode import check_debug_flags
from gpuar_tpu_torch.parallel.codec import DeviceCodec, _Slot


def shard_bounds(n: int, k: int) -> list[tuple[int, int]]:
    """Contiguous [a, b) packet ranges of n packets over k shards, balanced
    to within one packet; empty shards (n < k) are left out, so shard i
    always belongs to device i."""
    base, extra = divmod(n, k)
    bounds, a = [], 0
    for i in range(k):
        b = a + base + (i < extra)
        if b > a:
            bounds.append((a, b))
        a = b
    return bounds


class MeshCodec:
    """Encode/decode packet batches over a list of devices."""

    def __init__(self, devices, packet_size: int = UNCOMPRESSED_PACKET_SIZE,
                 debug: bool = False):
        if not devices:
            raise ValueError("MeshCodec needs at least one device")
        self.codecs = [DeviceCodec(d, packet_size=packet_size, debug=debug)
                       for d in devices]
        first = self.codecs[0]
        self.packet_size = first.packet_size
        self.debug = debug
        self.stride = first.stride
        self.row_bytes = first.row_bytes
        pinned = any(c.device.type == "cuda" for c in self.codecs)
        self._slots = [_Slot(pinned), _Slot(pinned)]
        self._next = 0

    def _slot(self) -> _Slot:
        # The batch buffers alternate like a DeviceCodec's: a decoded
        # batch stays readable until two submits later.
        slot = self._slots[self._next]
        self._next ^= 1
        return slot

    def _shards(self, n: int):
        return zip(self.codecs, shard_bounds(n, len(self.codecs)))

    # --- encode ------------------------------------------------------------
    def encode_body_async(self, data: np.ndarray, sizes: np.ndarray):
        """Launch every shard's K1 and compaction; returns one handle."""
        n = data.shape[0]
        return n, [(codec, codec.encode_body_async(data[a:b], sizes[a:b]))
                   for codec, (a, b) in self._shards(n)]

    def encode_body_wait(self, handle):
        """-> (.gip body uint8 [bytes], lengths int32 [n]) in packet
        order."""
        n, parts = handle
        buf = self._slot().buf("blob", n * self.stride)
        pos, offsets, lengths = 0, [np.zeros(0, np.int64)], \
            [np.zeros(0, np.int32)]
        for codec, h in parts:
            blob, offs, lens = codec.fetch_blob(h, into=buf[pos:])
            offsets.append(offs + pos)
            lengths.append(lens)
            pos += blob.size
        lengths = np.concatenate(lengths)
        return (native.splice_at(buf[:pos].numpy(), np.concatenate(offsets),
                                 lengths), lengths)

    # --- decode ------------------------------------------------------------
    def _out(self, n: int) -> torch.Tensor:
        return self._slot().buf("out", n * self.packet_size) \
            .view(n, self.packet_size)

    def decode_blob_async(self, blob: np.ndarray, roff: np.ndarray,
                          comp_len: np.ndarray, raw_sizes: np.ndarray):
        """Launch K2 (K3 under debug) on each shard of a reader-built blob
        (``decode_blob_geometry`` rows)."""
        n = raw_sizes.shape[0]
        out = self._out(n)
        rb = self.row_bytes
        parts = []
        for codec, (a, b) in self._shards(n):
            r0 = int(roff[a])
            stop = int(roff[b]) * rb if b < n else None
            parts.append((codec, codec.decode_blob_async(
                blob[r0 * rb: stop], roff[a:b] - r0, comp_len[a:b],
                raw_sizes[a:b], out=out[a:b])))
        return out, parts

    def decode_async(self, packets: np.ndarray, raw_sizes: np.ndarray):
        """Stride form: packets [n, S] uint8, split by rows."""
        out = self._out(packets.shape[0])
        return out, [(codec, codec.decode_async(packets[a:b], raw_sizes[a:b],
                                                out=out[a:b]))
                     for codec, (a, b) in self._shards(packets.shape[0])]

    def decode_body_wait(self, handle) -> np.ndarray:
        """-> raw uint8 [n, packet_size], a view of the batch buffer valid
        until two submits later (as DeviceCodec.decode_body_wait)."""
        out, parts = handle
        flags, comp_len = [np.zeros((2, 0), np.int32)], [np.zeros(0, np.int32)]
        for codec, h in parts:
            _, f, c = codec.wait_decoded(h)
            if self.debug:
                flags.append(f)
                comp_len.append(c)
        if self.debug:
            check_debug_flags(np.concatenate(flags, axis=1),
                              np.concatenate(comp_len), out.shape[0])
        return out.numpy()
