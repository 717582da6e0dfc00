"""DeviceCodec: the batch codec on one device.

The per-device part of ``gpuar_tpu/parallel/mesh.py::MeshCodec``; the port's
``parallel/mesh.py::MeshCodec`` runs one DeviceCodec per device.
A batch goes up through a pinned host buffer on a side CUDA stream, runs
through the K1 or K2/K3 kernel, and comes back through a pinned buffer;
the handle carries a CUDA event, so the pipeline's drive loop can submit
batch N+1 before it fetches batch N (the job JAX's async dispatch does on
the TPU).  Two slots of pinned buffers alternate, one per batch in flight.

The encode result is compacted on the device before it is fetched: each
packet's bytes are gathered into whole 96-byte rows of a dense blob
(``compact_rows``), so the download carries compressed bytes, and the host
strips the row padding with ``native.splice_at`` into the ``.gip`` body.
Decode reads the reader-built blob in place (K2 takes per-packet byte
offsets), so there is no expand gather.

What the JAX MeshCodec does for the TPU's sake and this class does not:
the entropy and density sorts, hull routing, ``_expand_rows``, lane
padding to a tile, the compilation cache and the host re-encode fixup (K1
has no error flag).

``device=torch.device("cpu")`` runs the same code with the kernels' plain
versions and no streams; only the tests choose it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gpuar_tpu_torch import native
from gpuar_tpu_torch.config import UNCOMPRESSED_PACKET_SIZE
from gpuar_tpu_torch.ops import _kernels
from gpuar_tpu_torch.ops import decode as dec_ops
from gpuar_tpu_torch.ops import encode as enc_ops

COMPACT_ROW_WORDS = 24   # 96-byte rows (divides out_words 2184 at 8192)
BUCKET_ROWS = 4096       # blob row multiple the packet reader pads to


def compact_rows(packets: torch.Tensor, lengths: torch.Tensor,
                 row_bytes: int):
    """Gather each packet's occupied rows into a dense blob.

    packets uint8 [n, stride] (stride a multiple of row_bytes), lengths
    [n] -> (blob uint8 [n*rows_pp, row_bytes], row offsets int64 [n],
    total rows int64 0-d), all on packets' device and without a host
    sync: a cumsum of row counts and a row-index gather
    (``mesh._compact_rows``).  Rows past the total are filler.
    """
    n, stride = packets.shape
    rows_pp = stride // row_bytes
    cap = n * rows_pp
    rcnt = (lengths.to(torch.int64) + row_bytes - 1) // row_bytes
    ends = torch.cumsum(rcnt, 0)
    roff = ends - rcnt
    r = torch.arange(cap, dtype=torch.int64, device=packets.device)
    p = torch.searchsorted(ends, r, right=True).clamp_(max=n - 1)
    src = (p * rows_pp + (r - roff[p])).clamp_(0, cap - 1)
    blob = packets.reshape(cap, row_bytes).index_select(0, src)
    return blob, roff, ends[-1]


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
        self.row_words = next(r for r in (COMPACT_ROW_WORDS, 16, 8)
                              if self.out_words % r == 0)
        self.row_bytes = self.row_words * 4
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

    def _upload(self, slot: _Slot, name: str, arr: np.ndarray):
        """Host array -> device tensor of the same dtype and shape, through
        the slot's pinned buffer (a copy, so read-only views are fine)."""
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
    def encode_body_async(self, data: np.ndarray, sizes: np.ndarray):
        """Launch K1 on padded raw packets [n, packet_size] and the device
        compaction; returns a handle for encode_body_wait."""
        n = data.shape[0]
        slot = self._slot()
        with self._on_stream():
            d_data = self._upload(slot, "data", data)
            d_sizes = self._upload(slot, "sizes",
                                   np.asarray(sizes, np.int32))
            packets, lengths = enc_ops.encode_batch(d_data, d_sizes)
            blob, roff, total = compact_rows(packets, lengths,
                                             self.row_bytes)
            meta = torch.cat([lengths.to(torch.int64), roff, total[None]])
            h_meta = self._download(slot, "meta", meta)
        return slot, self._record(slot), blob, h_meta, n

    def encode_body_wait(self, handle):
        """-> (.gip body uint8 [bytes], lengths int32 [n])."""
        blob, offsets, lengths = self.fetch_blob(handle)
        return native.splice_at(blob, offsets, lengths), lengths

    def fetch_blob(self, handle, into: torch.Tensor | None = None):
        """Wait for an encode_body_async batch and download the used part
        of its compacted blob -> (blob uint8 [bytes], packet byte offsets
        int64 [n] in it, lengths int32 [n]).  ``into``: a flat uint8 host
        tensor to download into (default the slot's pinned buffer)."""
        slot, event, blob, h_meta, n = handle
        self._wait(event)
        meta = h_meta.numpy()
        lengths = meta[:n].astype(np.int32)
        offsets = meta[n:2 * n] * self.row_bytes
        nbytes = int(meta[2 * n]) * self.row_bytes
        # The blob download goes on its own stream: the batch stream may
        # already hold the next batch's kernel, which this copy need not
        # wait for (the event above covered this batch's work).
        with (torch.cuda.stream(self._fetch_stream) if self._cuda
              else contextlib.nullcontext()):
            h_blob = self._download(
                slot, "blob", blob.view(-1)[:nbytes],
                into=None if into is None else into[:nbytes])
        if self._cuda:
            self._fetch_stream.synchronize()
        return h_blob.numpy(), offsets, lengths

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

    def decode_blob_async(self, blob: np.ndarray, roff: np.ndarray,
                          comp_len: np.ndarray, raw_sizes: np.ndarray,
                          out: torch.Tensor | None = None):
        """Launch K2 (K3 under debug) on a reader-built blob: packet i's
        framed bytes start at row roff[i] (``decode_blob_geometry`` rows).
        ``out``: a uint8 [n, packet_size] host tensor the result is
        downloaded into (default the slot's pinned buffer)."""
        slot = self._slot()
        with self._on_stream():
            res = dec_ops.decode_blob(
                self._upload(slot, "blob", blob),
                self._upload(slot, "offsets",
                             np.asarray(roff, np.int64) * self.row_bytes),
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
        two submits later (the drive loops write it out before that)."""
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
