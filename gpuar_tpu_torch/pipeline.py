"""Compressor orchestration: file → packets → codec backend → .gip file
(the port's copy of ``gpuar_tpu/pipeline.py``).

This is the equivalent of the reference's L4 layer (src/compressor.hpp,
src/cpu_compressor.cpp, src/gpu_compressor.cpp): it owns file I/O, splits
input into independent fixed-size packets, streams bounded super-batches
through a codec backend, and splices the variable-length results in order
into the .gip container.

Backends:
  * HostCompressor — the native C++ golden codec, serial per packet
    (reference `--host` path, src/cpu_compressor.cpp:112-207).
  * GPUCompressor  — the CUDA kernels over every local GPU (reference GPU
    path, src/gpu_compressor.cpp:124-196), in ``parallel/runner.py``.

What the JAX module has and this copy drops: the decode route hint
(``_hull_hint``; the port's kernels have one route).
"""

from __future__ import annotations

import os
import queue
import threading
from pathlib import Path

import numpy as np

from gpuar_tpu_torch import container, native
from gpuar_tpu_torch.config import (
    COMPRESSED_PACKET_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)
from gpuar_tpu_torch.utils.stats import CompressionInfo, ProgressMonitor, SplitTimer

# Bounded host memory per super-batch: the JAX package's 8192 packets,
# the default of HostCompressor, the sleep control and a GPUCompressor on
# CPU devices.  A GPUCompressor on the cards sizes its batch from them,
# as the reference does from the SM count (src/gpu_compressor.cpp:77-79):
# parallel/runner.py::card_batch_packets.
DEFAULT_SUPER_BATCH_PACKETS = 8192  # 64 MiB raw per super-batch


class Compressor:
    """Base: filenames + the compress/decompress drive loop."""

    # Backend packet geometry; decompress validates framed raw sizes
    # against THIS (a configurable-geometry backend must reject raw
    # sizes its kernels cannot decode).  GPUCompressor overrides it from
    # its codec.
    packet_size = UNCOMPRESSED_PACKET_SIZE

    def __init__(self, super_batch_packets: int = DEFAULT_SUPER_BATCH_PACKETS):
        self.super_batch_packets = super_batch_packets
        self._read_bufs = [np.empty(0, np.uint8), np.empty(0, np.uint8)]
        self._read_turn = 0

    # --- backend interface -------------------------------------------------
    def encode_batch(self, raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """raw bytes [n] -> (packets [p, COMPRESSED_PACKET_SIZE], lengths [p])."""
        raise NotImplementedError

    def decode_batch(self, packets: np.ndarray, raw_sizes: np.ndarray) -> np.ndarray:
        """packets [p, COMPRESSED_PACKET_SIZE] -> raw [p, UNCOMPRESSED_PACKET_SIZE]."""
        raise NotImplementedError

    def encode_buffer(self, nbytes: int) -> np.ndarray:
        """A flat uint8 host array of at least nbytes to read the next
        super-batch into; ``encode_submit`` gets the bytes read as a view
        of its head.  The default alternates two arrays, so a batch stays
        intact until two reads later: the drive loops hold one batch in
        flight while they read the next (the sleep control keeps it in its
        handle until fetch).  GPUCompressor hands out the pinned buffer
        its upload reads."""
        buf = self._read_bufs[self._read_turn]
        if buf.size < nbytes:
            buf = self._read_bufs[self._read_turn] = np.empty(nbytes, np.uint8)
        self._read_turn ^= 1
        return buf

    # Split submit/fetch interface for copy/compute/IO overlap — the
    # reference's rotating-stream pipeline (src/gpu_compressor.cpp:124-196).
    # Device backends override these so batch N+1's device work runs while
    # the host writes batch N's results; the default degrades to the
    # synchronous calls above.
    def encode_submit(self, raw: np.ndarray):
        return self.encode_batch(raw)

    def encode_fetch(self, handle):
        return handle

    def decode_submit(self, packets: np.ndarray, raw_sizes: np.ndarray):
        return self.decode_batch(packets, raw_sizes)

    def decode_fetch(self, handle):
        return handle

    # --- drive loops --------------------------------------------------------
    def compress(self, src: str | Path, dst: str | Path,
                 monitor: ProgressMonitor | None = None,
                 resume: bool = False) -> CompressionInfo:
        """Compress src into dst.

        The drive loop runs on three threads, like the reference's
        overlapped fill and drain (src/gpu_compressor.cpp:134-171).  For
        batch k this thread fetches batch k - 1 and hands its body to a
        writer thread, while a reader thread reads batch k straight into
        the backend's buffer; then it submits batch k and hands the reader
        batch k + 1's buffer.  Every backend call stays on this thread;
        writes stay in batch order.

        With ``resume=True`` an interrupted output is continued: packets
        are appended in order, so a partial .gip is a valid prefix — the
        existing complete packets are walked (validated) and the input is
        re-seeked past the bytes they cover (SURVEY.md §5 checkpoint
        bullet; the reference's append-ordered super-batch loop has the
        same property but no way to use it).
        """
        monitor = monitor or ProgressMonitor(enabled=False)
        monitor.reset()
        info = CompressionInfo()
        process, io = SplitTimer(), SplitTimer()
        batch_bytes = self.super_batch_packets * UNCOMPRESSED_PACKET_SIZE

        done_raw = done_comp = 0
        if resume and os.path.exists(dst):
            with io:
                done_raw, done_comp, last_packet = _resume_point(dst)
                _check_resume_matches(src, done_raw, last_packet)

        with io:
            info.uncompressed_file_size = os.path.getsize(src)
            fin = open(src, "rb")
            if done_comp:
                fout = open(dst, "r+b")
                fout.truncate(container.HEADER_LENGTH + done_comp)
                fout.seek(container.HEADER_LENGTH + done_comp)
                fin.seek(done_raw)
            else:
                fout = open(dst, "wb")
                fout.write(b"\0" * container.HEADER_LENGTH)
        info.compressed_file_size = container.HEADER_LENGTH + done_comp
        info.processed_uncompressed_size = done_raw

        reader, writer = _Lane("reader"), _Lane("writer")
        try:
            def hand():
                """The next batch's buffer, which the reader fills while
                this thread fetches the batch before the last."""
                with io:
                    buf = self.encode_buffer(batch_bytes)[:batch_bytes]
                reader.start(read_into, fin, buf)
                return buf

            buf = hand()
            pending = None  # (handle, chunk_len)
            eof = False
            while not eof or pending is not None:
                if pending is not None:
                    h, chunk_len = pending
                    with process:
                        packets, lengths = self.encode_fetch(h)
                    with io:
                        body = _splice(packets, lengths)
                    writer.start(fout.write, body)
                    info.compressed_file_size += len(body)
                    info.processed_uncompressed_size += chunk_len
                    monitor.update(info)
                    pending = None
                if not eof:
                    got = reader.wait()
                    if got:
                        with process:
                            pending = (self.encode_submit(buf[:got]), got)
                        buf = hand()
                    else:
                        eof = True
            writer.wait()

            with io:
                fout.seek(0)
                header = container.FileHeader(
                    uncompressed_size=info.uncompressed_file_size,
                    compressed_size=info.compressed_file_size,
                )
                fout.write(header.to_bytes())
        finally:
            reader.close()
            writer.close()
            fin.close()
            fout.close()

        monitor.finish()
        info.process_time = process.total
        info.io_time = io.total + reader.timer.total + writer.timer.total
        return info

    def decompress(self, src: str | Path, dst: str | Path,
                   monitor: ProgressMonitor | None = None) -> CompressionInfo:
        """Decompress src into dst, on three threads as ``compress``: the
        reader thread reads and walks batch k's packets while this thread
        fetches batch k - 1 and the writer thread writes it."""
        monitor = monitor or ProgressMonitor(enabled=False)
        monitor.reset()
        info = CompressionInfo()
        process, io = SplitTimer(), SplitTimer()

        with io:
            actual = os.path.getsize(src)
            fin = open(src, "rb")
        try:
            with io:
                head_raw = fin.read(container.HEADER_LENGTH)
            header = container.FileHeader.from_bytes(
                head_raw, actual_file_size=actual)
            with io:
                fout = open(dst, "wb")
        except BaseException:
            fin.close()
            raise
        info.uncompressed_file_size = header.uncompressed_size
        info.compressed_file_size = header.compressed_size

        n = self.super_batch_packets
        reader, writer = _Lane("reader"), _Lane("writer")
        try:
            packets_in = _PacketReader(
                fin, max_raw=getattr(self, "packet_size",
                                     UNCOMPRESSED_PACKET_SIZE))
            # Backends with decode_blob_buffer (GPUCompressor) take the
            # dense blob: the reader reads each batch's packets, as they
            # lie in the file, straight into the host buffer that
            # decode_blob_buffer hands out (the pinned one the upload
            # reads) and walks only their headers (read_batch_dense), so
            # no packet byte is copied before the H2D.  The others get a
            # fixed-stride batch.
            dense = hasattr(self, "decode_blob_buffer")
            submit = self.decode_submit_blob if dense else self.decode_submit

            def hand():
                """Start the reader on the next batch: into the buffer
                decode_blob_buffer hands out, or as a fixed-stride
                batch."""
                if not dense:
                    reader.start(packets_in.read_batch, n)
                    return
                with io:
                    out = self.decode_blob_buffer(
                        packets_in.dense_capacity(n))
                reader.start(packets_in.read_batch_dense, n, out)

            hand()
            pending = None  # (handle, raw_sizes)
            eof = False
            while not eof or pending is not None:
                if pending is not None:
                    h, sizes_n = pending
                    with process:
                        raw = self.decode_fetch(h)
                        body = _splice(raw, sizes_n)
                    writer.start(fout.write, body)
                    info.processed_uncompressed_size += int(sizes_n.sum())
                    monitor.update(info)
                    pending = None
                if not eof:
                    batch = reader.wait()
                    if not dense and batch[0] is None:
                        batch = None   # read_batch's EOF
                    if batch is None:
                        eof = True
                    else:
                        with process:
                            pending = (submit(*batch), batch[-1])
                        hand()
            writer.wait()
        finally:
            reader.close()
            writer.close()
            fin.close()
            fout.close()

        # A file truncated exactly at a packet boundary reads to a clean
        # EOF; the header totals are the only way to catch it.
        if info.processed_uncompressed_size != header.uncompressed_size:
            raise container.ContainerError(
                "Incorrect file format: decoded "
                f"{info.processed_uncompressed_size} bytes, header declares "
                f"{header.uncompressed_size} (truncated or corrupt file)"
            )
        monitor.finish()
        info.process_time = process.total
        info.io_time = io.total + reader.timer.total + writer.timer.total
        return info


def _resume_point(dst) -> tuple[int, int, bytes]:
    """(raw bytes covered, compressed body bytes, last complete packet) of
    the complete full-size packets at the head of an interrupted .gip
    output; the last packet is re-encoded by _check_resume_matches to
    verify the input hasn't changed.

    The walk stops at the first truncated or short-raw packet (a short raw
    size only occurs at the file tail, so everything after it is either
    done or garbage to overwrite).  The placeholder header is ignored — an
    interrupted run never finalised it.
    """
    done_raw = done_comp = 0
    last_packet = b""
    with open(dst, "rb") as f:
        f.seek(container.HEADER_LENGTH)
        while True:
            head = f.read(PACKET_HEADER_LENGTH)
            if len(head) < PACKET_HEADER_LENGTH:
                break
            try:
                total, raw = container.packet_sizes(head)
                container.validate_packet_header(
                    total, raw, UNCOMPRESSED_PACKET_SIZE)
            except container.ContainerError:
                break
            if raw != UNCOMPRESSED_PACKET_SIZE:
                break
            body = f.read(total - PACKET_HEADER_LENGTH)
            if len(body) < total - PACKET_HEADER_LENGTH:
                break
            done_comp += total
            done_raw += raw
            last_packet = head + body
    return done_raw, done_comp, last_packet


def _check_resume_matches(src, done_raw: int, last_packet: bytes) -> None:
    """Refuse to resume when src changed since the interrupted run: the
    retained packets must still encode the current input.  Spot-checked by
    re-encoding the last complete packet (any earlier divergence would
    produce a corrupt archive that only fails at decompress time)."""
    if done_raw == 0:
        return
    if done_raw > os.path.getsize(src):
        raise container.ContainerError(
            "Cannot resume: existing output covers more bytes than the "
            "input file now has (input changed since the interrupted run)"
        )
    with open(src, "rb") as f:
        f.seek(done_raw - UNCOMPRESSED_PACKET_SIZE)
        tail = f.read(UNCOMPRESSED_PACKET_SIZE)
    if native.encode_packet(tail) != last_packet:
        raise container.ContainerError(
            "Cannot resume: the input no longer matches the packets "
            "already in the output (input changed since the interrupted "
            "run); rerun without --resume"
        )


def read_into(f, buf: np.ndarray) -> int:
    """Fill the flat uint8 array buf from f with ``readinto`` until it is
    full or the file ends (a short read is not the end); returns the
    bytes read."""
    view, got = memoryview(buf), 0
    while got < buf.size:
        k = f.readinto(view[got:])
        if not k:
            break
        got += k
    return got


class _Lane:
    """A thread that runs the drive loop's file jobs one at a time, in the
    order they are handed to it: the reader's reads or the writer's
    writes.  ``start`` hands it the next job once the last has ended;
    ``wait`` returns the last job's result or raises its exception as it
    was raised.  ``timer`` sums the seconds of its jobs.

    Buffer lifetimes in the threaded drive loops.  The loop fetches
    batch k - 1 before it hands out batch k + 1's buffers and submits
    batch k, so the two slots of every buffer provider keep their rule
    (a batch's buffers stay valid until two reads or submits later).
    ``start`` waits for batch k - 2's write before batch k - 1's, and so
    before batch k's submit and fetch, which reuse the slot of batch
    k - 2's output (MeshCodec's ``out`` and ``blob``).

    The waits poll the thread, so a thread that ended never leaves the
    loop blocked, and ``close`` ends it once its job is done."""

    POLL_S = 0.1

    def __init__(self, name: str):
        self.name = name
        self.timer = SplitTimer()
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._done = threading.Event()
        self._done.set()
        self._result: tuple = (None, None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"gpuar-{name}")
        self._thread.start()

    def _run(self) -> None:
        while (job := self._jobs.get()) is not None:
            fn, args = job
            try:
                with self.timer:
                    self._result = (fn(*args), None)
            except BaseException as err:   # raised again by wait()
                self._result = (None, err)
            self._done.set()

    def start(self, fn, *args) -> None:
        self.wait()
        self._done.clear()
        self._jobs.put((fn, args))

    def wait(self):
        while not self._done.wait(self.POLL_S):
            if not self._thread.is_alive():
                raise RuntimeError(f"the {self.name} thread ended mid-job")
        (value, err), self._result = self._result, (None, None)
        if err is not None:
            raise err
        return value

    def close(self) -> None:
        """End the thread after its job (whose result is dropped)."""
        self._jobs.put(None)
        self._thread.join()


def _splice(packets: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate variable-length packets from a fixed-stride batch.

    A 1-D array is the body itself (the GPU path: G1 gathers it on the
    device, parallel/codec.DeviceCodec) and passes straight through.
    Returns a uint8 array: file.write takes it via the buffer protocol,
    so the GPU path ships a super-batch body with no host copy."""
    if packets.ndim == 1:
        return np.ascontiguousarray(packets)
    if packets.shape[0] == 0:
        return np.empty(0, np.uint8)
    stride = packets.shape[1]
    if (packets.flags.c_contiguous and 0 <= lengths[-1] <= stride
            and np.all(lengths[:-1] == stride)):
        # Every packet but the last fills its stride (every decompress
        # batch; the file's last packet may be short): the concatenation
        # is the buffer's head, a VIEW, not a whole-body memcpy on the
        # drive loop's process path.  A short packet before the last (the
        # container allows one) takes the copy.
        return packets.reshape(-1)[: (packets.shape[0] - 1) * stride
                                   + int(lengths[-1])]
    return native.splice(packets, lengths)


def blob_capacity(max_packets: int, row_bytes: int, bucket_rows: int) -> int:
    """Bytes of the largest blob ``_PacketReader.read_batch_blob`` builds
    from max_packets packets: each packet's rows at the longest packet,
    plus a bucket of padding rows."""
    rows_pp = -(-COMPRESSED_PACKET_SIZE // row_bytes)
    return (max_packets * rows_pp + bucket_rows) * row_bytes


class _PacketReader:
    """Block-buffered framed-packet reader: one read(2) per ~8 MiB
    instead of two per packet (the reference reads header-then-body per
    packet, src/gpu_compressor.cpp:299-310 — ~2.6 M syscalls on a 10 GB
    archive; the block walk keeps the same validation).

    Two forms, and a reader is read in one of them:

    * ``read_batch`` and ``read_batch_blob`` read the file with
      ``readinto`` into one reused block buffer, and ``native.
      walk_packets`` copies its packets into the batch: no Python runs
      per packet, only once a block.  At the end of a block the partial
      packet (under ``COMPRESSED_PACKET_SIZE`` bytes) moves to the front
      and the next block is read behind it.
    * ``read_batch_dense`` reads the file straight into the caller's
      buffer and walks only the packets' headers: the packets stay where
      they were read, and the bytes read past a batch's last whole packet
      (the carry) move to the front of the next batch's buffer."""

    # The least read of the dense form (at most a block): the reads that
    # finish a batch ask for about the bytes its remaining packets hold,
    # and no fewer than this.
    DENSE_TAIL = 64 << 10

    def __init__(self, fin, block_size: int = 8 << 20,
                 max_raw: int = UNCOMPRESSED_PACKET_SIZE):
        self._fin = fin
        self._block = block_size
        # Raw-size validation bound: the BACKEND's packet geometry (a
        # configurable-packet_size backend must reject raw sizes its
        # kernels cannot decode, not just ones over the global default).
        self._max_raw = max_raw
        self._buf = None   # the block buffer of the copying forms
        self._pos = 0   # next unread byte of _buf
        self._end = 0   # end of the bytes read into _buf
        self._eof = False
        self._sets = [None, None]   # see _batch_arrays
        self._turn = 0
        # The dense form: the carry (the last batch's buffer, the carry's
        # start and end in it), and the mean packet of the last walk that
        # found packets, which sizes the reads that finish a batch.
        self._carry = (None, 0, 0)
        self._mean = 0.0
        self.carried = 0   # bytes moved as carries

    def _batch_arrays(self, max_packets: int, nbytes: int = 0):
        """The next of two alternating sets of batch arrays: roff,
        comp_len and raw_sizes int32 [max_packets], a uint8 buffer of at
        least nbytes and boff int64 [max_packets].  A batch's arrays stay
        valid until two reads later, so the drive loop may hold one batch
        pending while it reads the next."""
        s = self._sets[self._turn]
        if s is None or s[0].size < max_packets or s[3].size < nbytes:
            s = self._sets[self._turn] = (
                *(np.empty(max_packets, np.int32) for _ in range(3)),
                np.empty(nbytes, np.uint8), np.empty(max_packets, np.int64))
        self._turn ^= 1
        return s

    def _refill(self) -> bool:
        """Move the unread tail to the front and read the next block
        behind it; False at EOF (nothing more was read)."""
        if self._eof:
            return False
        tail = self._end - self._pos
        self._buf[:tail] = self._buf[self._pos: self._end]
        got = self._fin.readinto(
            memoryview(self._buf)[tail: tail + self._block]) or 0
        self._pos, self._end = 0, tail + got
        self._eof = got == 0
        return not self._eof

    def _walk(self, max_packets: int, dst: np.ndarray, row_bytes: int,
              comp_len: np.ndarray, raw_sizes: np.ndarray,
              roff: np.ndarray | None = None) -> tuple[int, int]:
        """Walk up to max_packets packets into dst (``native.
        walk_packets``), refilling the block buffer as the walk needs;
        returns (packets, rows used).  Faults raise the ContainerError of
        a per-packet walk, with its text."""
        count = rows = 0
        if self._buf is None:
            self._buf = np.empty(self._block + COMPRESSED_PACKET_SIZE,
                                 np.uint8)
        while count < max_packets:
            stop, n, used, r = native.walk_packets(
                self._buf, self._pos, self._end, max_packets - count,
                self._max_raw, dst, row_bytes, rows, comp_len, raw_sizes,
                count, roff)
            count, rows, self._pos = count + n, rows + r, self._pos + used
            if stop == native.WALK_BAD_HEADER:
                total, raw = container.packet_sizes(
                    self._buf[self._pos: self._pos + PACKET_HEADER_LENGTH])
                container.validate_packet_header(total, raw, self._max_raw)
                raise RuntimeError("walk_packets refused a valid header")
            if stop == native.WALK_PARTIAL and not self._refill():
                have = self._end - self._pos
                if have == 0:
                    break
                raise container.ContainerError(
                    "Incorrect file format: truncated packet "
                    + ("header" if have < PACKET_HEADER_LENGTH else "body"))
        return count, rows

    def read_batch(self, max_packets: int):
        """Up to max_packets framed packets as a fixed-stride batch.

        Returns (packets [p, COMPRESSED_PACKET_SIZE] uint8, raw_sizes [p])
        or (None, None) at EOF, valid until two reads later.
        """
        _, comp_len, raw_sizes, packets, _ = self._batch_arrays(
            max_packets, max_packets * COMPRESSED_PACKET_SIZE)
        count, _ = self._walk(max_packets, packets, COMPRESSED_PACKET_SIZE,
                              comp_len, raw_sizes)
        if count == 0:
            return None, None
        return (packets[: count * COMPRESSED_PACKET_SIZE]
                .reshape(count, COMPRESSED_PACKET_SIZE), raw_sizes[:count])

    def read_batch_blob(self, max_packets: int, row_bytes: int,
                        bucket_rows: int, out: np.ndarray | None = None):
        """Up to max_packets framed packets as a compacted upload blob.

        No fixed-stride batch and no whole-body host pass: each packet's
        bytes are copied ONCE, straight from the block buffer into its
        row-aligned slot of the device upload blob, which K2 reads in
        place at per-packet offsets.  Mirrors the reference's overlapped
        fill/drain intent (src/gpu_compressor.cpp:287-343).

        ``out``: a flat uint8 array of at least ``blob_capacity`` bytes
        to build the blob in (the codec's pinned upload buffer, reused
        batch after batch); by default a new array.  Every byte of the
        blob is written, so stale bytes in ``out`` never show.

        Returns (blob [kb*row_bytes] uint8 with kb a bucket_rows
        multiple, a view of ``out``'s head when given, row_offsets [p]
        i32, comp_len [p] i32, raw_sizes [p] i32) or None at EOF; the
        three index arrays are valid until two reads later.  Validation
        matches read_batch.
        """
        cap = blob_capacity(max_packets, row_bytes, bucket_rows)
        if out is None:
            out = np.empty(cap, np.uint8)
        elif out.size < cap:
            raise ValueError(f"out holds {out.size} B, the batch needs "
                             f"{cap}")
        roff, comp_len, raw_sizes, _, _ = self._batch_arrays(max_packets)
        count, rows = self._walk(max_packets, out, row_bytes, comp_len,
                                 raw_sizes, roff)
        if count == 0:
            return None
        kb = -(-max(rows, 1) // bucket_rows) * bucket_rows
        out[rows * row_bytes: kb * row_bytes] = 0
        return (out[: kb * row_bytes], roff[:count], comp_len[:count],
                raw_sizes[:count])

    def dense_capacity(self, max_packets: int) -> int:
        """Bytes of the buffer ``read_batch_dense`` needs for batches of
        max_packets packets: each at the longest packet, plus one block
        (the most a read brings in past the batch's packets)."""
        return max_packets * COMPRESSED_PACKET_SIZE + self._block

    def read_batch_dense(self, max_packets: int,
                         out: np.ndarray | None = None):
        """Up to max_packets framed packets as a dense upload blob: the
        packets as they lie in the file, read with ``readinto`` straight
        into ``out`` and walked header by header (``native.walk_packets``
        with no destination), so no packet byte is copied.  K2 reads the
        blob in place at the packets' byte offsets.

        ``out``: a flat uint8 array of at least ``dense_capacity`` bytes
        (the codec's pinned upload buffer, handed out anew for each
        batch); by default a new array.  The bytes read past the batch's
        last whole packet are the carry: the next call moves them from
        this buffer to the front of its own, so this buffer is only read
        after the call (its upload may still be running).  The reads that
        finish a batch ask for about the bytes its remaining packets hold
        at the mean size of the packets last walked, so the carry stays
        small.

        Returns (blob uint8, a view of ``out``'s head that ends at the
        last packet's last byte, byte_offsets [p] i64, comp_len [p] i32,
        raw_sizes [p] i32) or None at EOF; the three index arrays are
        valid until two reads later.  Validation matches read_batch."""
        cap = self.dense_capacity(max_packets)
        if out is None:
            out = np.empty(cap, np.uint8)
        elif out.size < cap:
            raise ValueError(f"out holds {out.size} B, the batch needs "
                             f"{cap}")
        _, comp_len, raw_sizes, _, boff = self._batch_arrays(max_packets)
        end = self._carry_in(out)
        pos = count = 0
        while count < max_packets:
            stop, k, used, _ = native.walk_packets(
                out, pos, end, max_packets - count, self._max_raw, None, 0,
                0, comp_len, raw_sizes, count, boff=boff)
            count, pos = count + k, pos + used
            if k:
                self._mean = used / k
            if stop == native.WALK_BAD_HEADER:
                total, raw = container.packet_sizes(
                    out[pos: pos + PACKET_HEADER_LENGTH])
                container.validate_packet_header(total, raw, self._max_raw)
                raise RuntimeError("walk_packets refused a valid header")
            if stop != native.WALK_PARTIAL:
                break
            got = 0 if self._eof else self._fin.readinto(memoryview(out)[
                end: end + self._dense_read(max_packets - count,
                                            end - pos)]) or 0
            if not got:
                self._eof = True
                if end == pos:
                    break
                raise container.ContainerError(
                    "Incorrect file format: truncated packet "
                    + ("header" if end - pos < PACKET_HEADER_LENGTH
                       else "body"))
            end += got
        self._carry = (out, pos, end)
        if count == 0:
            return None
        return out[:pos], boff[:count], comp_len[:count], raw_sizes[:count]

    def _carry_in(self, out: np.ndarray) -> int:
        """Move the last batch's carry to the front of out; returns its
        bytes (the one copy of the dense form)."""
        last, a, b = self._carry
        self._carry = (None, 0, 0)
        if b > a:
            out[: b - a] = last[a:b]   # memmove where last is out
            self.carried += b - a
        return b - a

    def _dense_read(self, packets: int, have: int) -> int:
        """Bytes of the next read of a dense batch that lacks ``packets``
        packets with ``have`` bytes of them read: what they hold at the
        mean packet of the last walk (the packets just read, so the
        estimate follows the file's content), at least DENSE_TAIL (the
        first read, before any packet was walked), at most a block."""
        want = int(packets * self._mean) - have
        return min(self._block, max(self.DENSE_TAIL, want))


class HostCompressor(Compressor):
    """Native codec backend (the reference's --host mode), optionally
    multi-threaded.

    The reference's CPUCompressor codes packets strictly serially
    (src/cpu_compressor.cpp:151-181); packets are independent by
    construction (per-packet model reset), so with threads > 1 each
    super-batch is split into contiguous packet ranges coded in a thread
    pool — the ctypes calls release the GIL for the whole native batch,
    so Python threads scale to real cores.  threads=1 (the default) is
    byte-for-byte the serial path; any thread count produces an
    identical archive.
    """

    def __init__(self, super_batch_packets: int = DEFAULT_SUPER_BATCH_PACKETS,
                 threads: int = 1):
        super().__init__(super_batch_packets)
        if threads is None or threads < 1:
            threads = os.cpu_count() or 1
        self.threads = threads
        self._pool = None
        if threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=threads)

    def _split(self, n_items: int) -> list[tuple[int, int]]:
        per = -(-n_items // self.threads)
        return [(i, min(i + per, n_items))
                for i in range(0, n_items, per)]

    def encode_batch(self, raw: np.ndarray):
        P = UNCOMPRESSED_PACKET_SIZE
        n_packets = -(-raw.size // P)
        if self._pool is None or n_packets < 2 * self.threads:
            return native.encode_batch(raw)
        ranges = self._split(n_packets)
        futs = [self._pool.submit(native.encode_batch,
                                  raw[i0 * P: min(i1 * P, raw.size)])
                for i0, i1 in ranges]
        parts = [f.result() for f in futs]
        return (np.concatenate([p for p, _ in parts]),
                np.concatenate([ln for _, ln in parts]))

    def decode_batch(self, packets: np.ndarray, raw_sizes: np.ndarray):
        if self._pool is None or packets.shape[0] < 2 * self.threads:
            out, lengths = native.decode_batch(packets)
        else:
            ranges = self._split(packets.shape[0])
            futs = [self._pool.submit(native.decode_batch,
                                      packets[i0:i1])
                    for i0, i1 in ranges]
            parts = [f.result() for f in futs]
            out = np.concatenate([p for p, _ in parts])
            lengths = np.concatenate([ln for _, ln in parts])
        if not np.array_equal(lengths, raw_sizes):
            raise container.ContainerError(
                "Incorrect file format: decoded size mismatch"
            )
        return out


def generate_random_file(path: str | Path, size: int, seed: int | None = None) -> None:
    """Random test corpus, like Compressor::generateRandomFile
    (src/compressor.cpp:28-44)."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        remaining = size
        while remaining > 0:
            n = min(remaining, 64 * 1024 * 1024)
            f.write(rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())
            remaining -= n


def verify_archive(path: str | Path, deep: bool = False,
                   threads: int = 1) -> dict:
    """Integrity-check a ``.gip`` archive without writing any output
    (CLI verb ``v`` — an extension; the reference has no verify mode,
    only the manual md5 procedure in its README:24-29).

    Structural pass (always): file-header version/size validation, a
    full packet-chain walk (header bounds, body completeness), only the
    final packet may be short, and the summed raw sizes must equal the
    file header's uncompressed size.

    Deep pass (``deep=True``): additionally decodes every packet on the
    host codec and applies the kernel's bitstream-overrun rule (the
    decoder legitimately reads at most 16 lookahead bits past the framed
    stream — ops.decode.check_debug_flags; native
    tg_decode_packet_delta is the host mirror).  Catches corrupt
    well-framed packets that release-mode decode would silently turn
    into garbage, exactly like the reference's ``-D_DEBUG`` build.

    ``threads`` fans the deep decodes out to a worker pool (0 = all
    cores; packets are independent and the ctypes call releases the GIL,
    mirroring HostCompressor --threads).  The structural walk and the
    verdict are unaffected by the thread count.

    Returns a stats dict on success; raises ContainerError (or OSError)
    on the first violation.
    """
    # Same thread-count semantics as HostCompressor: None or < 1 means
    # all cores.
    if threads is None or threads < 1:
        threads = os.cpu_count() or 1
    pool = None
    if deep and threads != 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=threads)

    def _deep_check(idx: int, pkt: bytes) -> None:
        _, delta = native.decode_packet_delta(pkt)
        if delta > 16:
            raise container.ContainerError(
                f"Corrupt packet data: bitstream overrun in "
                f"packet {idx} (+{delta} bits past the framed stream)")

    size = os.path.getsize(path)
    futures = []
    try:
        with open(path, "rb") as f:
            header = container.FileHeader.from_bytes(
                f.read(container.HEADER_LENGTH), actual_file_size=size)
            if header.compressed_size != size:
                raise container.ContainerError(
                    f"Incorrect file format: header compressed size "
                    f"{header.compressed_size} != actual file size {size}")
            total_raw = 0
            n = 0
            short_at = None
            for pkt in container.read_packets(f):
                total, raw = container.packet_sizes(pkt[:4])
                if raw == 0:
                    raise container.ContainerError(
                        f"Incorrect file format: packet {n} has zero "
                        f"raw size")
                if short_at is not None:
                    raise container.ContainerError(
                        f"Incorrect file format: short packet {short_at} "
                        f"before the final packet")
                if raw < UNCOMPRESSED_PACKET_SIZE:
                    short_at = n
                if deep:
                    if pool is None:
                        _deep_check(n, pkt)
                    else:
                        futures.append(pool.submit(_deep_check, n, pkt))
                        if len(futures) >= 8192:  # bound held pkts ~64 MiB
                            futures.pop(0).result()
                total_raw += raw
                n += 1
            if total_raw != header.uncompressed_size:
                raise container.ContainerError(
                    f"Incorrect file format: packets decode to {total_raw} "
                    f"bytes, header says {header.uncompressed_size}")
        if pool is not None:
            for fut in futures:
                fut.result()  # re-raise the first worker's ContainerError
    finally:
        # Shutdown on EVERY exit path: an error mid-walk must not leave
        # thousands of queued packet decodes to drain at interpreter exit
        # (or leak worker threads in library use).
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
    return {
        "valid": True,
        "packets": n,
        "uncompressed_size": total_raw,
        "compressed_size": size,
        "deep": bool(deep),
    }
