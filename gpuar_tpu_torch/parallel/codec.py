"""DeviceCodec: the batch codec on one device.

The per-device part of ``gpuar_tpu/parallel/mesh.py::MeshCodec``; the port's
``parallel/mesh.py::MeshCodec`` runs one DeviceCodec per device.
A batch goes up through a pinned host buffer on a side CUDA stream, runs
through K1 and G1 or through K2/K3, and comes back through a pinned buffer;
the handle carries a CUDA event, so the pipeline's drive loop can submit
batch N+1 before it fetches batch N (the job JAX's async dispatch does on
the TPU).  Two slots of pinned buffers alternate, one per batch in flight.

The encode result is gathered on the device before it is fetched: G1
(``ops.encode.gather_body``) puts each packet's bytes at their byte
offset in the batch's ``.gip`` body, so the download is the body as it
lies in the file and the host splices nothing.  Decode reads the reader's
dense blob in place, the packets as they lie in the file at their byte
offsets (K2 takes per-packet byte offsets), so there is no expand gather.

What the JAX MeshCodec does for the TPU's sake and this class does not:
the entropy and density sorts, hull routing, ``_compact_rows`` and the
host splice of its 96-byte rows, ``_expand_rows``, lane padding to a
tile, the compilation cache and the host re-encode fixup (K1 has no error
flag).

``device=torch.device("cpu")`` runs the same code with the kernels' plain
versions and no streams; only the tests choose it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gpuar_tpu_torch.config import UNCOMPRESSED_PACKET_SIZE
from gpuar_tpu_torch.ops import _kernels
from gpuar_tpu_torch.ops import decode as dec_ops
from gpuar_tpu_torch.ops import encode as enc_ops


class _Slot:
    """Host buffers of one in-flight batch (pinned for a CUDA device) and
    the event that marks the end of its last device work."""

    def __init__(self, pinned: bool = True):
        self.pinned = pinned
        self.bufs: dict[str, torch.Tensor] = {}
        self.event: torch.cuda.Event | None = None

    def buf(self, name: str, nbytes: int) -> torch.Tensor:
        b = self.bufs.get(name)
        if b is None or b.numel() < nbytes:
            b = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                            pin_memory=self.pinned)
            self.bufs[name] = b
        return b[:nbytes]


class DeviceCodec:
    """Encode/decode packet batches on one device."""

    def __init__(self, device: torch.device | str | None = None,
                 packet_size: int = UNCOMPRESSED_PACKET_SIZE,
                 debug: bool = False):
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.packet_size = packet_size
        # debug=True decodes through K3: coder invariants plus bitstream
        # overrun, so corrupt well-framed packets raise ContainerError.
        self.debug = debug
        _, self.out_words = enc_ops.out_geometry(packet_size)
        self.stride = self.out_words * 4
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._fetch_stream = torch.cuda.Stream(self.device) if self._cuda \
            else None
        self._slots = [_Slot(), _Slot()]
        self._next = 0

    # --- transfers ---------------------------------------------------------
    def _slot(self) -> _Slot:
        slot = self._slots[self._next]
        self._next ^= 1
        if slot.event is not None:
            slot.event.synchronize()  # its pinned buffers are free again
        return slot

    def _on_stream(self):
        if not self._cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _upload(self, slot: _Slot, name: str, arr):
        """Host array -> device tensor of the same dtype and shape, through
        the slot's pinned buffer (a copy, so read-only views are fine).  A
        host tensor (MeshCodec's data or blob buffer, filled from the
        file) goes up as it is, with no copy; on a CUDA device it must be
        pinned, or the copy would be a staged, synchronous one."""
        if isinstance(arr, torch.Tensor):
            if not self._cuda:
                return arr
            if not arr.is_pinned():
                raise ValueError(f"upload of {name!r}: host tensor not pinned")
            return arr.to(self.device, non_blocking=True)
        arr = np.asarray(arr)
        if not self._cuda:
            return torch.from_numpy(np.array(arr, copy=True))
        pinned = slot.buf(name, arr.nbytes)
        np.copyto(pinned.numpy().view(arr.dtype).reshape(arr.shape), arr)
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        return pinned.to(self.device, non_blocking=True).view(dtype) \
            .reshape(arr.shape)

    def _download(self, slot: _Slot, name: str, t: torch.Tensor,
                  into: torch.Tensor | None = None):
        """Device tensor -> pinned host tensor (valid after the slot's
        event); CPU tensors pass through.  ``into``: a host tensor of t's
        shape to copy into instead of the slot's buffer (MeshCodec's batch
        buffer)."""
        if into is not None:
            into.copy_(t, non_blocking=self._cuda)
            return into
        if not self._cuda:
            return t
        flat = t.contiguous().view(-1).view(torch.uint8)
        host = slot.buf(name, flat.numel())
        host.copy_(flat, non_blocking=True)
        return host.view(t.dtype).reshape(t.shape)

    def _record(self, slot: _Slot):
        if self._cuda:
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        return slot.event

    @staticmethod
    def _wait(event) -> None:
        if event is not None:
            event.synchronize()

    # --- encode ------------------------------------------------------------
    def encode_body_async(self, data: np.ndarray | torch.Tensor,
                          sizes: np.ndarray):
        """Launch K1 on padded raw packets [n, packet_size], then G1, which
        gathers the batch's body on the device; returns a handle for
        encode_body_wait.  A host tensor ``data`` (pinned for a CUDA
        device) is uploaded as it is, an array through the slot's pinned
        buffer."""
        n = data.shape[0]
        slot = self._slot()
        with self._on_stream():
            d_data = self._upload(slot, "data", data)
            d_sizes = self._upload(slot, "sizes",
                                   np.asarray(sizes, np.int32))
            packets, lengths = enc_ops.encode_batch(d_data, d_sizes)
            body, total = enc_ops.gather_body(packets, lengths)
            meta = torch.cat([lengths.to(torch.int64), total[None]])
            h_meta = self._download(slot, "meta", meta)
        return slot, self._record(slot), body, h_meta, n

    def encode_body_wait(self, handle, into: torch.Tensor | None = None):
        """Wait for an encode_body_async batch and download exactly its
        body's bytes -> (.gip body uint8 [bytes], lengths int32 [n]).
        ``into``: a flat uint8 host tensor to download into (MeshCodec's
        batch buffer); by default the body is a view of the slot's pinned
        buffer, valid until the slot's next batch is fetched, two submits
        later."""
        slot, event, body, h_meta, n = handle
        self._wait(event)
        meta = h_meta.numpy()
        lengths = meta[:n].astype(np.int32)
        nbytes = int(meta[n])
        # The body's download goes on its own stream: the batch stream may
        # already hold the next batch's kernels, which this copy need not
        # wait for (the event above covered this batch's work).
        with (torch.cuda.stream(self._fetch_stream) if self._cuda
              else contextlib.nullcontext()):
            h_body = self._download(
                slot, "blob", body[:nbytes],
                into=None if into is None else into[:nbytes])
        if self._cuda:
            self._fetch_stream.synchronize()
        return h_body.numpy(), lengths

    def encode_body(self, data: np.ndarray, sizes: np.ndarray):
        """encode_body_wait(encode_body_async(data, sizes))."""
        return self.encode_body_wait(self.encode_body_async(data, sizes))

    def encode(self, data: np.ndarray, sizes: np.ndarray):
        """Stride path: padded raw packets [n, packet_size] uint8 ->
        (packets uint8 [n, out_words*4], lengths int32 [n])."""
        slot = self._slot()
        with self._on_stream():
            packets, lengths = enc_ops.encode_batch(
                self._upload(slot, "data", data),
                self._upload(slot, "sizes", np.asarray(sizes, np.int32)))
            h_pk = self._download(slot, "packets", packets)
            h_len = self._download(slot, "lengths", lengths)
        self._wait(self._record(slot))
        return h_pk.numpy().copy(), h_len.numpy().copy()

    # --- decode ------------------------------------------------------------
    def _decode_tail(self, slot, out, comp_len, into):
        if self.debug:
            out, flags = out
            h_flags = self._download(slot, "flags", flags)
        else:
            h_flags = None
        h_out = self._download(slot, "out", out, into=into)
        return slot, self._record(slot), h_out, h_flags, comp_len

    def decode_blob_async(self, blob: np.ndarray | torch.Tensor,
                          offsets: np.ndarray, comp_len: np.ndarray,
                          raw_sizes: np.ndarray,
                          out: torch.Tensor | None = None):
        """Launch K2 (K3 under debug) on a reader-built blob: packet i's
        framed bytes start at byte offsets[i] (int64; the dense blob of
        ``_PacketReader.read_batch_dense``, or any blob of packets at
        byte offsets).  A host tensor ``blob`` (pinned for a CUDA device)
        is uploaded as it is, an array through the slot's pinned buffer.
        ``out``: a uint8 [n, packet_size] host tensor the result is
        downloaded into (default the slot's pinned buffer)."""
        slot = self._slot()
        with self._on_stream():
            res = dec_ops.decode_blob(
                self._upload(slot, "blob", blob),
                self._upload(slot, "offsets", np.asarray(offsets, np.int64)),
                self._upload(slot, "raw", np.asarray(raw_sizes, np.int32)),
                packet_size=self.packet_size, debug=self.debug)
            return self._decode_tail(slot, res, np.asarray(comp_len), out)

    def decode_async(self, packets: np.ndarray, raw_sizes: np.ndarray,
                     out: torch.Tensor | None = None):
        """Stride form: packets [n, S] uint8 (S >= every packet's length);
        ``out`` as for decode_blob_async."""
        comp_len = (packets[:, 0].astype(np.int32)
                    | (packets[:, 1].astype(np.int32) << 8))
        slot = self._slot()
        with self._on_stream():
            res = dec_ops.decode_batch(
                self._upload(slot, "packets", packets),
                self._upload(slot, "raw", np.asarray(raw_sizes, np.int32)),
                packet_size=self.packet_size, debug=self.debug)
            return self._decode_tail(slot, res, comp_len, out)

    def decode_body_wait(self, handle) -> np.ndarray:
        """-> raw uint8 [n, packet_size].  The array is a view of the
        slot's pinned buffer: it stays valid until the slot's next batch,
        two submits later (the drive loops' writer thread has written it
        before that batch's submit)."""
        raw, flags, comp_len = self.wait_decoded(handle)
        if self.debug:
            dec_ops.check_debug_flags(flags, comp_len, raw.shape[0])
        return raw

    def wait_decoded(self, handle):
        """Wait for a decode handle -> (raw uint8 [n, packet_size], debug
        flags int32 [2, n] or None, comp_len [n]); the flags are not
        checked."""
        slot, event, h_out, h_flags, comp_len = handle
        self._wait(event)
        return (h_out.numpy(),
                None if h_flags is None else h_flags.numpy(), comp_len)

    def launches(self) -> dict[str, int]:
        """Kernel launches on this codec's stream since the last
        ``_kernels.reset_counts()`` (all 0 on the CPU)."""
        return _kernels.launches_on(
            self._stream.cuda_stream if self._cuda else None)

    def decode(self, packets: np.ndarray, raw_sizes: np.ndarray):
        """Stride path, synchronous -> raw uint8 [n, packet_size] (a copy)."""
        return self.decode_body_wait(
            self.decode_async(packets, raw_sizes)).copy()
