"""MeshCodec: the batch codec over several devices.

The counterpart of the multi-device part of
``gpuar_tpu/parallel/mesh.py::MeshCodec``.  JAX pads a batch to
``devices x tile`` lanes and ``shard_map`` splits the lane axis over a 1-D
mesh; here a batch of n packets is cut into contiguous shards, balanced to
within one packet, and each shard goes to the DeviceCodec of its device
(its own streams, pinned buffers and events).  Packets are independent, so
the devices never exchange data: the host splits each batch and joins the
results in packet order.

- Encode: shard k is the batch's rows ``a_k .. b_k``.  The file pipeline
  reads the batch into the batch slot's ``[n, packet_size]`` host buffer
  (``encode_buffer``, pinned for a CUDA device), so each shard uploads
  its rows of it with no host copy; an array from elsewhere is copied
  into that buffer first.  Each shard's G1 gathers the shard's ``.gip``
  body on its device, and each body is downloaded into one pinned batch
  buffer right after the one before it: the shards are contiguous packet
  ranges, so the buffer's head is then the batch's body, with nothing
  concatenated or spliced on the host.
- Decode: shard k of the reader-built blob is its bytes ``off[a_k] ..
  off[b_k]`` (the last shard's to the blob's end), its offsets rebased
  to zero.  The file pipeline has the reader read the dense blob into the
  batch slot's host buffer (``blob_buffer``, pinned for a CUDA device),
  so each shard uploads its slice of it with no host copy; a blob from
  elsewhere is copied into that buffer first.
  Every shard's output is downloaded straight into its rows of one pinned
  ``[n, packet_size]`` batch buffer, so the host never concatenates
  shards; debug flags are joined in packet order and checked once.
- Each batch of either verb takes the next of two batch slots when it is
  submitted.  A slot's data or blob buffer is handed out again only once
  every shard's batch that last read the slot has finished, so the drive
  loops, which hold one batch in flight while they read the next, never
  overwrite bytes a copy to the card has yet to read.  A slot's output
  (the decoded batch, the body) stays valid until two submits
  later; the drive loops' writer thread has written it before then
  (``pipeline._Lane``).
- The JAX class's synchronous stride API (``encode``, ``encode_async`` /
  ``encode_wait``, ``encode_body``, ``decode``, ``decode_wait``) runs the
  same shards: each shard's fixed-stride packets and lengths land in its
  rows of one batch buffer.  The file pipeline does not call it.

One device takes the same path as several, with one shard.
What the JAX class needs and this one drops: lane padding to a quantum
(``lane_quantum``); the super-batch stays the total number of packets over
all devices.  Two entries of ``devices`` may name one card: each gets its
own DeviceCodec and streams (the CPU tests run k shards on ``[cpu] * k``).
"""

from __future__ import annotations

import numpy as np
import torch

from gpuar_tpu_torch.config import UNCOMPRESSED_PACKET_SIZE
from gpuar_tpu_torch.ops import encode as enc_ops
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
        pinned = any(c.device.type == "cuda" for c in self.codecs)
        self._slots = [_Slot(pinned), _Slot(pinned)]
        self._next = 0
        # Per slot, each shard's event of the last batch that read the
        # slot's data or blob buffer: waited on before either is written
        # again.
        self._uploads: list[list] = [[], []]
        self._handed = None  # (name, slot index, tensor) last handed out

    def _slot(self) -> _Slot:
        # The batch buffers alternate like a DeviceCodec's: a decoded
        # batch stays readable until two submits later.
        slot = self._slots[self._next]
        self._next ^= 1
        return slot

    def _shards(self, n: int):
        return zip(self.codecs, shard_bounds(n, len(self.codecs)))

    # --- host staging ------------------------------------------------------
    def _staging(self, i: int, name: str, nbytes: int) -> torch.Tensor:
        """Slot i's host buffer ``name`` of nbytes, once every shard's
        batch that last read the slot has finished."""
        for event in self._uploads[i]:
            DeviceCodec._wait(event)
        self._uploads[i] = []
        return self._slots[i].buf(name, nbytes)

    def _hand(self, name: str, nbytes: int) -> np.ndarray:
        """The buffer ``name`` of the slot the next submit takes, as a flat
        uint8 host array to build the next batch in."""
        staging = self._staging(self._next, name, nbytes)
        self._handed = (name, self._next, staging)
        return staging.numpy()

    def _staged(self, name: str, i: int, arr: np.ndarray) -> torch.Tensor:
        """Slot i's buffer ``name`` holding arr's bytes, flat: the handed
        buffer itself when arr was built at its head, else a copy."""
        handed, self._handed = self._handed, None
        if handed is not None and handed[0] == name \
                and arr.ctypes.data == handed[2].data_ptr():
            if handed[1] != i:
                raise RuntimeError(f"{name} was built in the other batch "
                                   "slot's buffer")
            return handed[2][: arr.nbytes]
        staged = self._staging(i, name, arr.nbytes)
        staged.numpy()[:] = arr.reshape(-1)
        return staged

    # --- encode ------------------------------------------------------------
    def encode_buffer(self, n: int) -> np.ndarray:
        """A uint8 [n, packet_size] host array to read the next batch
        into: the data buffer of the batch slot that the next
        encode_body_async takes (pinned for a CUDA device), which uploads
        it with no copy when given it as ``data``."""
        return self._hand("data", n * self.packet_size) \
            .reshape(n, self.packet_size)

    def encode_body_async(self, data: np.ndarray, sizes: np.ndarray):
        """Launch every shard's K1 and G1; returns one handle.  Every
        shard uploads its rows of the slot's data buffer: a batch read
        into ``encode_buffer`` is already there, any other array is copied
        in first."""
        n = data.shape[0]
        i = self._next
        slot = self._slot()
        staged = self._staged("data", i, data).view(n, self.packet_size)
        parts = [(codec, codec.encode_body_async(staged[a:b], sizes[a:b]))
                 for codec, (a, b) in self._shards(n)]
        self._uploads[i] = [h[1] for _, h in parts]
        return slot, n, parts

    def encode_body_wait(self, handle):
        """-> (.gip body uint8 [bytes], lengths int32 [n]) in packet
        order.  Each shard's body is downloaded at the end of the one
        before it in the slot's blob buffer, whose head is then the
        batch's body: it stays valid until the wait of the slot's next
        batch, two submits later (the drive loops' writer thread has
        written it before that batch's submit)."""
        slot, n, parts = handle
        buf = slot.buf("blob", n * self.stride)
        pos, lengths = 0, [np.zeros(0, np.int32)]
        for codec, h in parts:
            body, lens = codec.encode_body_wait(h, into=buf[pos:])
            lengths.append(lens)
            pos += body.size
        return buf[:pos].numpy(), np.concatenate(lengths)

    def encode_body(self, data: np.ndarray, sizes: np.ndarray):
        """encode_body_wait(encode_body_async(data, sizes))."""
        return self.encode_body_wait(self.encode_body_async(data, sizes))

    def encode_async(self, data: np.ndarray, sizes: np.ndarray):
        """Launch every shard's K1 with its fixed-stride result downloaded
        into the shard's rows of one batch buffer; returns a handle for
        encode_wait."""
        n = data.shape[0]
        slot = self._slot()
        packets = slot.buf("packets", n * self.stride).view(n, self.stride)
        lengths = slot.buf("lengths", 4 * n).view(torch.int32)
        parts = []
        for codec, (a, b) in self._shards(n):
            cs = codec._slot()
            with codec._on_stream():
                pk, ln = enc_ops.encode_batch(
                    codec._upload(cs, "data", data[a:b]),
                    codec._upload(cs, "sizes",
                                  np.asarray(sizes[a:b], np.int32)))
                codec._download(cs, "packets", pk, into=packets[a:b])
                codec._download(cs, "lengths", ln, into=lengths[a:b])
            parts.append((codec, codec._record(cs)))
        return packets, lengths, parts

    def encode_wait(self, handle):
        """-> (packets uint8 [n, stride], lengths int32 [n]) in packet
        order, copies (as DeviceCodec.encode returns them)."""
        packets, lengths, parts = handle
        for codec, event in parts:
            codec._wait(event)
        return packets.numpy().copy(), lengths.numpy().copy()

    def encode(self, data: np.ndarray, sizes: np.ndarray):
        """Padded raw packets [n, packet_size] uint8 -> (packets uint8
        [n, stride], lengths int32 [n])."""
        return self.encode_wait(self.encode_async(data, sizes))

    # --- decode ------------------------------------------------------------
    def _out(self, slot: _Slot, n: int) -> torch.Tensor:
        return slot.buf("out", n * self.packet_size).view(n, self.packet_size)

    def blob_buffer(self, nbytes: int) -> np.ndarray:
        """A flat uint8 host array of nbytes to build the next batch's blob
        in: the blob buffer of the batch slot that the next
        decode_blob_async takes (pinned for a CUDA device), which uploads
        it with no copy when given its head as ``blob``."""
        return self._hand("blob", nbytes)

    def decode_blob_async(self, blob: np.ndarray, offsets: np.ndarray,
                          comp_len: np.ndarray, raw_sizes: np.ndarray):
        """Launch K2 (K3 under debug) on each shard of a reader-built blob
        of packets at byte offsets (int64).  Every shard uploads its slice
        of the slot's blob buffer: a blob built in ``blob_buffer`` is
        already there, any other array is copied in first."""
        n = raw_sizes.shape[0]
        i = self._next
        slot = self._slot()
        out = self._out(slot, n)
        staged = self._staged("blob", i, blob)
        parts = []
        for codec, (a, b) in self._shards(n):
            o0 = int(offsets[a])
            stop = int(offsets[b]) if b < n else None
            parts.append((codec, codec.decode_blob_async(
                staged[o0: stop], offsets[a:b] - o0, comp_len[a:b],
                raw_sizes[a:b], out=out[a:b])))
        self._uploads[i] = [h[1] for _, h in parts]
        return out, parts

    def decode_async(self, packets: np.ndarray, raw_sizes: np.ndarray):
        """Stride form: packets [n, S] uint8, split by rows."""
        out = self._out(self._slot(), packets.shape[0])
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

    # The JAX class's name for the wait of decode_async.
    decode_wait = decode_body_wait

    def decode(self, packets: np.ndarray, raw_sizes: np.ndarray):
        """Stride form, synchronous -> raw uint8 [n, packet_size] (a
        copy)."""
        return self.decode_body_wait(
            self.decode_async(packets, raw_sizes)).copy()
