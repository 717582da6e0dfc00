"""Multi-host compression over torch.distributed (``--multihost``).

The counterpart of ``gpuar_tpu/parallel/distributed.py``, with the same
protocol and the same archive:

* compress: every process (rank) codes a packet-aligned byte range of the
  input on its local GPUs and spools its body; the body sizes are
  all-gathered, an exclusive scan turns them into file offsets, rank 0
  writes the 20-byte header, and every rank writes its body at its offset;
* decompress: rank 0 walks the packet index of the archive and broadcasts
  it in geometrically growing groups of super-batch segments as it walks;
  segment s is decoded by rank ``s % world`` and written at its walked raw
  offset.  A backend with the blob interface (GPUCompressor) gets each
  segment as a dense blob, its packets as they lie in the file, any other
  (HostCompressor, the sleep control) as a fixed-stride batch.

Every process needs the same shared filesystem.  The pure planning
helpers, the index walks, the prefetch thread and the segment loaders are
copies of the JAX module's.  Its five collective seams are replaced here with
``torch.distributed`` on **gloo**:
``initialize``, ``process_info``, ``_allgather_sizes`` (int64 travels as
it is, so the u32 halves are gone), ``_barrier`` and the broadcasts of
``_segment_stream``.  Gloo and not NCCL: the payload is host metadata, and
two ranks that share one card cannot form an NCCL group.  The segment
stream's broadcasts run on a prefetch thread, so they get a gloo group of
their own: two threads never share one group's collective sequence.

Both loops run on three threads, on the local drive loops' terms
(``pipeline.Compressor``, ``pipeline._Lane``): a reader thread reads the
next batch into the backend's upload buffer (compress) or reads the
next owned segment's body straight into the buffer
``decode_blob_buffer`` hands out (decompress), and a writer thread
appends each body to the rank's spool or writes each decoded segment at
its raw offset.

A world of one (nothing configured) runs the local pipeline's bytes with
no collective at all.
"""

from __future__ import annotations

import itertools
import os
import queue
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gpuar_tpu_torch import container, native
from gpuar_tpu_torch.config import (
    COMPRESSED_PACKET_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)
from gpuar_tpu_torch.pipeline import (
    _Lane,
    _splice,
    read_into,
)
from gpuar_tpu_torch.utils.stats import (
    CompressionInfo,
    ProgressMonitor,
    SplitTimer,
)


# --------------------------------------------------------------------------
# Pure planners (copies of the JAX module's)
# --------------------------------------------------------------------------

def host_ranges(file_size: int, n_hosts: int,
                packet_size: int = UNCOMPRESSED_PACKET_SIZE
                ) -> list[tuple[int, int]]:
    """Split [0, file_size) into n_hosts packet-aligned (start, stop) ranges.

    Every range holds a whole number of packets; the final range carries
    the file tail.  Ranges are balanced to within one packet.
    """
    n_packets = -(-file_size // packet_size) if file_size else 0
    base, extra = divmod(n_packets, n_hosts)
    ranges = []
    start_pkt = 0
    for h in range(n_hosts):
        count = base + (1 if h < extra else 0)
        start = start_pkt * packet_size
        stop = min((start_pkt + count) * packet_size, file_size)
        ranges.append((min(start, file_size), max(stop, min(start, file_size))))
        start_pkt += count
    return ranges


def exclusive_scan(sizes: np.ndarray) -> np.ndarray:
    """Byte offsets for each host's body given per-host compressed sizes."""
    sizes = np.asarray(sizes, dtype=np.int64)
    out = np.zeros_like(sizes)
    np.cumsum(sizes[:-1], out=out[1:])
    return out


def walk_packet_index(stream, compressed_body_size: int,
                      block_size: int = 8 << 20) -> np.ndarray:
    """Scan the packet headers of a .gip body -> a [2, n+1] int64 index:
    row 0 the compressed byte offsets of the packets (relative to the
    body), row 1 the raw offsets, each ending with the total.  Raw offsets
    come from the packets' raw-size headers, so short non-final packets
    land right; sizes are validated as the walk hops header to header.
    The whole-body form of ``walk_packet_index_chunks``, which decode
    uses."""
    # Every packet takes at least its 4-byte header, so a segment of
    # body-size packets is never cut: the walk yields one segment.
    segs = list(walk_packet_index_chunks(
        stream, compressed_body_size, max(compressed_body_size, 1),
        block_size))
    return segs[0] if segs else np.zeros((2, 1), np.int64)


def walk_packet_index_chunks(stream, compressed_body_size: int,
                             chunk_packets: int,
                             block_size: int = 8 << 20):
    """Incremental walk_packet_index: yields [2, k+1] segments of at most
    chunk_packets packets (absolute offsets, same layout) as the walk
    progresses, so decoding can start after ONE segment instead of after
    a full-archive read (the de-serialized prologue, VERDICT r2 item 4).
    """
    buf = b""
    buf_base = 0
    pos = 0
    raw_pos = 0
    offsets = [0]
    raw_offsets = [0]
    while pos < compressed_body_size:
        if pos + PACKET_HEADER_LENGTH > buf_base + len(buf):
            stream.seek(pos)
            buf = stream.read(min(block_size, compressed_body_size - pos))
            buf_base = pos
            if len(buf) < PACKET_HEADER_LENGTH:
                raise container.ContainerError(
                    "Incorrect file format: truncated packet header"
                )
        rel = pos - buf_base
        total, raw = container.packet_sizes(
            buf[rel:rel + PACKET_HEADER_LENGTH])
        container.validate_packet_header(total, raw, UNCOMPRESSED_PACKET_SIZE)
        pos += total
        raw_pos += raw
        offsets.append(pos)
        raw_offsets.append(raw_pos)
        if len(offsets) == chunk_packets + 1:
            yield np.asarray([offsets, raw_offsets], dtype=np.int64)
            offsets = [pos]
            raw_offsets = [raw_pos]
    if pos != compressed_body_size:
        raise container.ContainerError(
            "Incorrect file format: packet overruns the declared size"
        )
    if len(offsets) > 1:
        yield np.asarray([offsets, raw_offsets], dtype=np.int64)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None) -> None:
    """Join the world: ``init_process_group(backend="gloo")``.

    Without arguments the world comes from the environment (``env://``:
    torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
    where ``WORLD_SIZE`` is not set nothing is configured and the process
    stays a world of one.  Explicit arguments (a ``tcp://`` or ``file://``
    init method, the world size and this rank) take its place.  A world
    that is configured but cannot form raises.  A no-op once initialised.
    """
    if dist.is_initialized():
        return
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return
    dist.init_process_group(
        backend="gloo", init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def process_info() -> tuple[int, int]:
    """(rank, world size) — (0, 1) when no group is initialised."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_sizes(local_size: int) -> np.ndarray:
    """All-gather one int64 per rank (identity on a world of one)."""
    rank, world = process_info()
    if world == 1:
        return np.asarray([local_size], dtype=np.int64)
    mine = torch.tensor([local_size], dtype=torch.int64)
    got = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(got, mine)
    sizes = torch.cat(got).numpy()
    if sizes[rank] != local_size:
        raise RuntimeError(
            f"all-gather round-trip mismatch: {sizes[rank]} != {local_size}")
    return sizes


def _barrier() -> None:
    if process_info()[1] > 1:
        dist.barrier()


def _broadcast(arr: np.ndarray, group) -> np.ndarray:
    """Rank 0's ``arr`` on every rank of ``group`` (received in place)."""
    dist.broadcast(torch.from_numpy(arr), src=0, group=group)
    return arr


def _segment_stream(body, body_size: int, rank: int, world: int,
                    chunk_packets: int, group=None,
                    group_max: int | None = None):
    """Yield packet-index segments ([2, k+1] absolute offsets) on every
    rank: rank 0 walks the body and broadcasts the index as it goes, so
    decoding starts after one segment.  World 1 is the plain walk.

    The protocol of the JAX ``_segment_stream``: broadcasts carry 1, 2,
    4, ... up to ``group_max`` segments (one gloo broadcast costs
    milliseconds of latency, so one per segment would rate-limit decode);
    the packet count K rides in the pad's last column (K == 0 ends the
    stream) and the walker's segment size beside it, which receivers
    check; receivers re-slice the group into ``chunk_packets``
    segments."""
    if world == 1:
        yield from walk_packet_index_chunks(body, body_size, chunk_packets)
        return
    if group_max is None:
        group_max = max(8, 2 * world)
    pad = np.zeros((2, group_max * chunk_packets + 2), np.int64)
    if rank == 0:
        walker = walk_packet_index_chunks(body, body_size, chunk_packets)
        group_size = 1
        while True:
            segs = list(itertools.islice(walker, group_size))
            total = sum(s.shape[1] - 1 for s in segs)
            pad[0, -1] = total
            pad[1, -1] = chunk_packets
            pos = 0
            for s in segs:
                # Adjacent segments share their join column.
                pad[:, pos: pos + s.shape[1]] = s
                pos += s.shape[1] - 1
            _broadcast(pad, group)
            if total == 0:
                return
            yield from segs
            group_size = min(group_size * 2, group_max)
    else:
        while True:
            # A fresh buffer per broadcast: the segments yielded from the
            # last one may still wait in the prefetch queue.
            got = _broadcast(np.zeros_like(pad), group)
            total = int(got[0, -1])
            if total == 0:
                return
            if int(got[1, -1]) != chunk_packets:
                raise RuntimeError(
                    "segment-stream chunk mismatch: rank 0 walks "
                    f"{int(got[1, -1])} packets/segment, this rank expects "
                    f"{chunk_packets} — hosts must configure the same "
                    "super_batch_packets")
            for lo in range(0, total, chunk_packets):
                hi = min(lo + chunk_packets, total)
                yield got[:, lo: hi + 1]


class DistributedCompressor:
    """Multi-host compressor: every rank runs it against a shared
    filesystem; on a world of one it writes the local pipeline's archive.

    The local codec work goes to a per-process ``pipeline.Compressor``
    backend, by default GPUCompressor on this process's local GPUs.
    Decode hands each owned segment to the backend's blob interface
    (``decode_blob_buffer``, ``decode_submit_blob``) where it has one, as
    the dense blob read into the buffer ``decode_blob_buffer`` hands out,
    and to ``decode_submit`` as a fixed-stride batch where it has not
    (HostCompressor, the sleep control).  Every rank plans with one
    super-batch: rank 0's, where a rank's backend sized its own from its
    card (``_agree_batch``).

    Both loops run on three threads, as the local drive loops do
    (``pipeline.Compressor``): for batch or owned segment k this thread
    fetches k - 1 and hands its body to a writer thread, waits for the
    reader thread's k and submits it, then hands the reader k + 1.  Every
    backend call and every collective stays on this thread (the segment
    stream's broadcasts on the prefetch thread, in stream order).

    After each call ``coord`` is a SplitTimer of the seconds this thread
    spent in collectives, barriers and waits on the segment prefetcher,
    and ``lane_seconds`` the reader's and the writer's busy seconds
    (which ``CompressionInfo.io_time`` also counts, beside the walk waits
    and the loop thread's own file work).
    """

    def __init__(self, backend=None):
        if backend is None:
            from gpuar_tpu_torch.parallel.runner import GPUCompressor

            backend = GPUCompressor()
        self.backend = backend
        self._batch_agreed = False
        self._stream_group = None
        self.coord = SplitTimer()
        self.lane_seconds = {"reader": 0.0, "writer": 0.0}
        # The reader's segment bytes: it does one job at a time, so one
        # array serves every segment.
        self._segment_bytes = np.empty(0, np.uint8)

    def _agree_batch(self, coord: SplitTimer) -> None:
        """Once, on this thread: every rank whose backend sized its
        super-batch from its card (``batch_from_card``) takes rank 0's,
        since ranks with other cards or card counts would size theirs
        otherwise and plan other segments.  An explicit size is kept;
        decompress's segment stream checks that the ranks' agree."""
        if self._batch_agreed:
            return
        self._batch_agreed = True
        if process_info()[1] == 1:
            return
        size = torch.tensor([self.backend.super_batch_packets],
                            dtype=torch.int64)
        with coord:
            dist.broadcast(size, src=0)
        if getattr(self.backend, "batch_from_card", False):
            self.backend.super_batch_packets = int(size[0])

    def _finish(self, info: CompressionInfo, process: SplitTimer,
                io: SplitTimer, reader: _Lane, writer: _Lane) -> None:
        """A call's seconds into info and ``lane_seconds``."""
        info.process_time = process.total
        info.io_time = io.total + reader.timer.total + writer.timer.total
        self.lane_seconds = {"reader": reader.timer.total,
                             "writer": writer.timer.total}

    def compress(self, src: str | Path, dst: str | Path,
                 monitor: ProgressMonitor | None = None,
                 resume: bool = False) -> CompressionInfo:
        if resume:
            raise ValueError(
                "--resume is not supported with --multihost (the offsets of "
                "every host's body change when any range is re-encoded)")

        rank, world = process_info()
        # Progress is rank-local (against this rank's range) and printed
        # by rank 0 only.
        monitor = monitor or ProgressMonitor(enabled=False)
        monitor.enabled = monitor.enabled and rank == 0
        monitor.reset()
        info = CompressionInfo()
        process, io = SplitTimer(), SplitTimer()
        coord = self.coord = SplitTimer()
        self._agree_batch(coord)
        info.uncompressed_file_size = os.path.getsize(src)
        start, stop = host_ranges(info.uncompressed_file_size, world)[rank]
        local = CompressionInfo(uncompressed_file_size=stop - start)

        # Encode this rank's range, the writer spooling the body
        # to a temp file so memory stays bounded by one super-batch.
        batch = self.backend.super_batch_packets * UNCOMPRESSED_PACKET_SIZE
        with open(src, "rb") as fin, \
                tempfile.TemporaryFile(dir=os.path.dirname(
                    os.path.abspath(dst))) as spool:
            with io:
                fin.seek(start)
            todo = stop - start
            body_size = 0
            reader, writer = _Lane("reader"), _Lane("writer")
            try:
                def hand():
                    """Start the reader on the next batch, read into the
                    backend's buffer; -> (the buffer, its bytes)."""
                    want = min(batch, todo)
                    with io:
                        buf = self.backend.encode_buffer(want)[:want]
                    reader.start(read_into, fin, buf)
                    return buf, want

                if todo > 0:
                    buf, want = hand()
                pending = None  # (handle, chunk_len)
                while todo > 0 or pending is not None:
                    if pending is not None:
                        h, chunk_len = pending
                        with process:
                            packets, lengths = self.backend.encode_fetch(h)
                            piece = _splice(packets, lengths)
                        writer.start(spool.write, piece)
                        body_size += len(piece)
                        local.processed_uncompressed_size += chunk_len
                        monitor.update(local)
                        pending = None
                    if todo > 0:
                        got = reader.wait()
                        if got:
                            with process:
                                pending = (self.backend.encode_submit(
                                    buf[:got]), got)
                        # A short read is the file's end: the range ends.
                        todo = todo - got if got == want else 0
                        if todo > 0:
                            buf, want = hand()
                writer.wait()
            finally:
                reader.close()
                writer.close()

            # Metadata exchange: sizes -> offsets; ordered parallel splice.
            with coord:
                sizes = _allgather_sizes(body_size)
            offsets = exclusive_scan(sizes) + container.HEADER_LENGTH
            total = int(container.HEADER_LENGTH + sizes.sum())
            info.compressed_file_size = total
            info.processed_uncompressed_size = info.uncompressed_file_size

            if rank == 0:
                with io, open(dst, "wb") as f:
                    f.truncate(total)
                    f.write(container.FileHeader(
                        uncompressed_size=info.uncompressed_file_size,
                        compressed_size=total).to_bytes())
            with coord:
                _barrier()  # the header is written and the file sized
            with io, open(dst, "r+b") as f:
                f.seek(int(offsets[rank]))
                spool.seek(0)
                while blk := spool.read(64 << 20):
                    f.write(blk)
        with coord:
            _barrier()  # every body is written
        monitor.finish()
        self._finish(info, process, io, reader, writer)
        return info

    def _segment_array(self, nbytes: int) -> np.ndarray:
        """The reused array the stride loader reads a segment's body
        into, at least nbytes: grown, on this thread between the reader's
        jobs, to the most a segment of super-batch packets can hold."""
        if self._segment_bytes.size < nbytes:
            self._segment_bytes = np.empty(max(
                nbytes, self.backend.super_batch_packets
                * COMPRESSED_PACKET_SIZE), np.uint8)
        return self._segment_bytes

    def decompress(self, src: str | Path, dst: str | Path,
                   monitor: ProgressMonitor | None = None) -> CompressionInfo:
        rank, world = process_info()
        coord = self.coord = SplitTimer()
        self._agree_batch(coord)
        if world > 1 and self._stream_group is None:
            # Collective: every rank creates it on its first decompress.
            with coord:
                self._stream_group = dist.new_group(backend="gloo")
        monitor = monitor or ProgressMonitor(enabled=False)
        monitor.enabled = monitor.enabled and rank == 0
        monitor.reset()
        info = CompressionInfo()
        process, io = SplitTimer(), SplitTimer()
        actual = os.path.getsize(src)
        with open(src, "rb") as fin:
            with io:
                header = container.FileHeader.from_bytes(
                    fin.read(container.HEADER_LENGTH), actual_file_size=actual)
            info.uncompressed_file_size = header.uncompressed_size
            info.compressed_file_size = header.compressed_size

            # Rank 0 walks the packet headers and broadcasts the index one
            # super-batch segment at a time as it walks; segments are
            # owned round-robin (segment s -> rank s % world), and every
            # rank starts decoding after the first segment.  Only the
            # reader touches ``body``'s file.
            body = _BodyView(fin, container.HEADER_LENGTH)
            body_size = header.compressed_size - container.HEADER_LENGTH
            chunkp = self.backend.super_batch_packets
            blob_buffer = getattr(self.backend, "decode_blob_buffer", None)
            submit = self.backend.decode_submit if blob_buffer is None \
                else self.backend.decode_submit_blob
            # Progress is global: segment raw offsets come from the walked
            # index, so the end offset of the last segment this rank
            # finished covers every earlier segment, whoever owned it.
            local = CompressionInfo()
            local.uncompressed_file_size = header.uncompressed_size

            if rank == 0:
                with io, open(dst, "wb") as f:
                    f.truncate(info.uncompressed_file_size)
            with coord:
                _barrier()  # the output exists at its full size

            raw_total = 0
            seg_no = 0
            with open(dst, "r+b") as fout, open(src, "rb") as fwalk:
                # The walk and its broadcasts run on a prefetch thread with
                # their own file handle (a shared fd would race seeks with
                # the segment loads), off the decode critical path.
                segs = _IterPrefetcher(_segment_stream(
                    _BodyView(fwalk, container.HEADER_LENGTH), body_size,
                    rank, world, chunkp, group=self._stream_group))
                reader, writer = _Lane("reader"), _Lane("writer")
                try:
                    def next_owned():
                        """The next segment this rank owns, or None at
                        the stream's end; the raw total follows every
                        segment, owned or not."""
                        nonlocal raw_total, seg_no
                        while True:
                            with io, coord:
                                seg = next(segs, None)
                            if seg is None:
                                return None
                            raw_total = int(seg[1, -1])
                            seg_no += 1
                            if (seg_no - 1) % world == rank:
                                return seg

                    def hand(seg):
                        """Start the reader on an owned segment: its body
                        read into the buffer decode_blob_buffer hands out
                        (GPUCompressor: the pinned one the upload reads),
                        or a fixed-stride batch."""
                        if blob_buffer is None:
                            reader.start(_load_segment, body, seg,
                                         self._segment_array(
                                             int(seg[0, -1] - seg[0, 0])))
                            return
                        with io:
                            out = blob_buffer(
                                chunkp * COMPRESSED_PACKET_SIZE)
                        reader.start(_load_segment_blob, body, seg, out)

                    seg = next_owned()
                    if seg is not None:
                        hand(seg)
                    pending = None  # (handle, raw_sizes, raw_lo, raw_hi)
                    while seg is not None or pending is not None:
                        if pending is not None:
                            h, raw_sizes, raw_lo, raw_hi = pending
                            with process:
                                piece = _splice(self.backend.decode_fetch(h),
                                                raw_sizes)
                            writer.start(_write_at, fout, raw_lo, piece)
                            local.processed_uncompressed_size = raw_hi
                            monitor.update(local)
                            pending = None
                        if seg is not None:
                            loaded = reader.wait()
                            with process:
                                pending = (submit(*loaded), loaded[-1],
                                           int(seg[1, 0]), int(seg[1, -1]))
                            seg = next_owned()
                            if seg is not None:
                                hand(seg)
                    writer.wait()
                finally:
                    reader.close()
                    writer.close()
                    segs.close()
            if raw_total != header.uncompressed_size:
                raise container.ContainerError(
                    "Incorrect file format: packet raw sizes total "
                    f"{raw_total}, header declares "
                    f"{header.uncompressed_size}")
        # The stream is drained (its thread done, all its broadcasts
        # issued) before this barrier.
        with coord:
            _barrier()  # every segment is written
        # The final segments may be owned by other ranks; print the
        # remaining deciles before the closing line.
        local.processed_uncompressed_size = local.uncompressed_file_size
        monitor.update(local)
        monitor.finish()
        info.processed_uncompressed_size = info.uncompressed_file_size
        self._finish(info, process, io, reader, writer)
        return info


def _write_at(f, offset: int, data) -> None:
    """The decompress writer's job: data at byte ``offset`` of f."""
    f.seek(offset)
    f.write(data)


class _IterPrefetcher:
    """Drain an iterator on a daemon thread into a bounded queue.

    Used to pull the segment-index stream (and its per-segment broadcast
    collectives) OFF the decode critical path: the thread runs the walk
    and the collectives ahead of the main loop, so by the time a rank
    needs segment N+1 its index is already local.  Collective ordering
    stays valid: each rank issues the stream's collectives from exactly
    one thread, in stream order, and the main loop drains the stream to
    exhaustion (thread done, all collectives issued) before the final
    barrier.  Iterator errors re-raise on the consumer side.  ``close``
    stops the thread after its current step on a loop that ends early."""

    _DONE = object()
    CLOSE_S = 60.0

    def __init__(self, it, depth: int = 8):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, args=(it,),
                                   daemon=True, name="gpuar-walk")
        self._t.start()

    def _run(self, it):
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as exc:  # re-raised on the consumer thread
            self._err = exc
        self._put(self._DONE)

    def _put(self, item) -> bool:
        """Queue item; False once closed (the queue may stay full)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._t.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the thread after its current step (a block of the walk,
        or a broadcast, which ends once the peers take part or fail) and
        join it, for at most CLOSE_S seconds."""
        self._stop.set()
        self._t.join(self.CLOSE_S)


class _BodyView:
    """Seek/read view of a file past a fixed header offset."""

    def __init__(self, stream, base: int):
        self._stream = stream
        self._base = base

    def seek(self, pos: int) -> None:
        self._stream.seek(self._base + pos)

    def read(self, n: int) -> bytes:
        return self._stream.read(n)

    def readinto(self, b) -> int:
        return self._stream.readinto(b)


def _read_segment(body: "_BodyView", seg: np.ndarray,
                  data: np.ndarray | None = None):
    """One walked segment's body bytes -> (data uint8, comp_len int32 [k],
    raw_sizes int32 [k]).  ``data``: a flat uint8 array to ``readinto``
    (reused segment after segment; the bytes are a view of its head),
    by default a new one.  The walk validates headers only, so a body cut
    off mid-packet is first seen here."""
    off = seg[0]
    comp_len = np.diff(off).astype(np.int32)
    raw_sizes = np.diff(seg[1]).astype(np.int32)
    base = int(off[0])
    size = int(off[-1]) - base
    if data is None:
        data = np.empty(size, np.uint8)
    body.seek(base)
    if read_into(body, data[:size]) < size:
        raise container.ContainerError(
            "Incorrect file format: truncated packet body"
        )
    return data[:size], comp_len, raw_sizes


def _load_segment(body: "_BodyView", seg: np.ndarray,
                  data: np.ndarray | None = None):
    """Load one walked index segment ([2, k+1] absolute offsets) into a
    fixed-stride batch for ``decode_submit``: (packets uint8 [k,
    COMPRESSED_PACKET_SIZE], each packet's framed bytes at the start of
    its row and zeros after them; raw_sizes int32 [k]).  One
    ``native.expand_at`` scatter builds it, not a loop over packets;
    ``data`` as ``_read_segment``'s."""
    data, comp_len, raw_sizes = _read_segment(body, seg, data)
    k = comp_len.shape[0]
    stride = COMPRESSED_PACKET_SIZE
    packets = native.expand_at(data, np.arange(k, dtype=np.int64) * stride,
                               comp_len, k * stride)
    return packets.reshape(k, stride), raw_sizes


def _load_segment_blob(body: "_BodyView", seg: np.ndarray,
                       out: np.ndarray | None = None):
    """Load one walked index segment as a dense upload blob: the segment's
    body IS the packets' concatenation, so it is read with ``readinto``
    straight into ``out`` (the backend's ``decode_blob_buffer``, reused
    batch after batch; by default a new array) and each packet's byte
    offset comes from the walked index.  No byte is copied after the
    read.  Returns (blob, a view of ``out``'s head, byte_offsets int64
    [k], comp_len int32 [k], raw_sizes int32 [k]) for
    backend.decode_submit_blob; a body cut off mid-packet raises as
    ``_read_segment``."""
    size = int(seg[0, -1] - seg[0, 0])
    if out is not None and out.size < size:
        raise ValueError(f"out holds {out.size} B, the segment needs {size}")
    blob, comp_len, raw_sizes = _read_segment(body, seg, out)
    return (blob, (seg[0, :-1] - seg[0, 0]).astype(np.int64, copy=False),
            comp_len, raw_sizes)
