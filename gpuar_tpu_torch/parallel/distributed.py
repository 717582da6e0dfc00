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
  offset.  A backend with the compacted-blob interface (GPUCompressor)
  gets each segment as a row-aligned blob, any other (HostCompressor, the
  sleep control) as a fixed-stride batch.

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

A world of one (nothing configured) runs the local pipeline's bytes with
no collective at all.
"""

from __future__ import annotations

import itertools
import os
import tempfile
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
from gpuar_tpu_torch.pipeline import _splice, read_into
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
    Decode hands each owned segment to the backend's compacted-blob
    interface (``decode_blob_geometry``, ``decode_submit_blob``) where it
    has one, and to ``decode_submit`` as a fixed-stride batch where it has
    not (HostCompressor, the sleep control).
    """

    def __init__(self, backend=None):
        if backend is None:
            from gpuar_tpu_torch.parallel.runner import GPUCompressor

            backend = GPUCompressor()
        self.backend = backend
        self._stream_group = None

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
        info.uncompressed_file_size = os.path.getsize(src)
        start, stop = host_ranges(info.uncompressed_file_size, world)[rank]
        local = CompressionInfo(uncompressed_file_size=stop - start)

        # Encode this rank's range, spooling the spliced body to a temp
        # file so memory stays bounded by one super-batch.
        batch = self.backend.super_batch_packets * UNCOMPRESSED_PACKET_SIZE
        with open(src, "rb") as fin, \
                tempfile.TemporaryFile(dir=os.path.dirname(
                    os.path.abspath(dst))) as spool:
            with io:
                fin.seek(start)
            todo = stop - start
            body_size = 0
            # Submit-ahead, as in the local drive loop: the devices run
            # batch N+1 while this rank spools batch N.
            pending = None  # (handle, chunk_len)
            while todo > 0 or pending is not None:
                handle = None
                if todo > 0:
                    want = min(batch, todo)
                    with io:
                        buf = self.backend.encode_buffer(want)
                        got = read_into(fin, buf[:want])
                    todo -= got
                    if got:
                        with process:
                            handle = (self.backend.encode_submit(buf[:got]),
                                      got)
                    else:
                        todo = 0
                if pending is not None:
                    h, chunk_len = pending
                    with process:
                        packets, lengths = self.backend.encode_fetch(h)
                        piece = _splice(packets, lengths)
                    with io:
                        spool.write(piece)
                    body_size += len(piece)
                    local.processed_uncompressed_size += chunk_len
                    monitor.update(local)
                pending = handle

            # Metadata exchange: sizes -> offsets; ordered parallel splice.
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
            _barrier()  # the header is written and the file sized
            with io, open(dst, "r+b") as f:
                f.seek(int(offsets[rank]))
                spool.seek(0)
                while blk := spool.read(64 << 20):
                    f.write(blk)
        _barrier()  # every body is written
        monitor.finish()
        info.process_time = process.total
        info.io_time = io.total
        return info

    def decompress(self, src: str | Path, dst: str | Path,
                   monitor: ProgressMonitor | None = None) -> CompressionInfo:
        rank, world = process_info()
        if world > 1 and self._stream_group is None:
            # Collective: every rank creates it on its first decompress.
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
            # rank starts decoding after the first segment.
            body = _BodyView(fin, container.HEADER_LENGTH)
            body_size = header.compressed_size - container.HEADER_LENGTH
            chunkp = self.backend.super_batch_packets
            blob_geom = getattr(self.backend, "decode_blob_geometry", None)
            if blob_geom is not None:
                blob_geom = blob_geom()
            # Progress is global: segment raw offsets come from the walked
            # index, so the end offset of the last segment this rank
            # finished covers every earlier segment, whoever owned it.
            local = CompressionInfo()
            local.uncompressed_file_size = header.uncompressed_size

            if rank == 0:
                with io, open(dst, "wb") as f:
                    f.truncate(info.uncompressed_file_size)
            _barrier()  # the output exists at its full size

            raw_total = 0
            with open(dst, "r+b") as fout, open(src, "rb") as fwalk:
                # The walk and its broadcasts run on a prefetch thread with
                # their own file handle (a shared fd would race seeks with
                # the segment loads), off the decode critical path.
                segs = _IterPrefetcher(_segment_stream(
                    _BodyView(fwalk, container.HEADER_LENGTH), body_size,
                    rank, world, chunkp, group=self._stream_group))
                pending = None  # (handle, raw_sizes, raw_lo, raw_hi)

                def _drain(p):
                    h, raw_sizes, raw_lo, raw_hi = p
                    with process:
                        piece = _splice(self.backend.decode_fetch(h),
                                        raw_sizes)
                    with io:
                        fout.seek(raw_lo)
                        fout.write(piece)
                    local.processed_uncompressed_size = raw_hi
                    monitor.update(local)

                seg_no = 0
                while True:
                    with io:
                        seg = next(segs, None)
                    if seg is None:
                        break
                    raw_total = int(seg[1, -1])
                    if seg_no % world == rank:
                        # Fetch the previous owned segment only once this
                        # one is submitted, so the device decodes N+world
                        # while this rank writes N.
                        if blob_geom is not None:
                            with io:
                                ublob, roff, clen, raw_sizes = \
                                    _load_segment_blob(body, seg, *blob_geom)
                            with process:
                                h = self.backend.decode_submit_blob(
                                    ublob, roff, clen, raw_sizes)
                        else:
                            with io:
                                packets, raw_sizes = _load_segment(body, seg)
                            with process:
                                h = self.backend.decode_submit(packets,
                                                               raw_sizes)
                        handle = (h, raw_sizes, int(seg[1, 0]),
                                  int(seg[1, -1]))
                        if pending is not None:
                            _drain(pending)
                        pending = handle
                    seg_no += 1
                if pending is not None:
                    _drain(pending)
            if raw_total != header.uncompressed_size:
                raise container.ContainerError(
                    "Incorrect file format: packet raw sizes total "
                    f"{raw_total}, header declares "
                    f"{header.uncompressed_size}")
        # The stream is drained (its thread done, all its broadcasts
        # issued) before this barrier.
        _barrier()  # every segment is written
        # The final segments may be owned by other ranks; print the
        # remaining deciles before the closing line.
        local.processed_uncompressed_size = local.uncompressed_file_size
        monitor.update(local)
        monitor.finish()
        info.processed_uncompressed_size = info.uncompressed_file_size
        info.process_time = process.total
        info.io_time = io.total
        return info


class _IterPrefetcher:
    """Drain an iterator on a daemon thread into a bounded queue.

    Used to pull the segment-index stream (and its per-segment broadcast
    collectives) OFF the decode critical path: the thread runs the walk
    and the collectives ahead of the main loop, so by the time a rank
    needs segment N+1 its index is already local.  Collective ordering
    stays valid: each rank issues the stream's collectives from exactly
    one thread, in stream order, and the main loop drains the stream to
    exhaustion (thread done, all collectives issued) before the final
    barrier.  Iterator errors re-raise on the consumer side."""

    _DONE = object()

    def __init__(self, it, depth: int = 8):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._t = threading.Thread(
            target=self._run, args=(it,), daemon=True)
        self._t.start()

    def _run(self, it):
        try:
            for item in it:
                self._q.put(item)
        except BaseException as exc:  # re-raised on the consumer thread
            self._err = exc
        finally:
            self._q.put(self._DONE)

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


class _BodyView:
    """Seek/read view of a file past a fixed header offset."""

    def __init__(self, stream, base: int):
        self._stream = stream
        self._base = base

    def seek(self, pos: int) -> None:
        self._stream.seek(self._base + pos)

    def read(self, n: int) -> bytes:
        return self._stream.read(n)


def _read_segment(body: "_BodyView", seg: np.ndarray):
    """One walked segment's body bytes -> (data uint8, comp_len int32 [k],
    raw_sizes int32 [k]).  The walk validates headers only, so a body cut
    off mid-packet is first seen here."""
    off = seg[0]
    comp_len = np.diff(off).astype(np.int32)
    raw_sizes = np.diff(seg[1]).astype(np.int32)
    base = int(off[0])
    body.seek(base)
    data = body.read(int(off[-1]) - base)
    if len(data) < int(off[-1]) - base:
        raise container.ContainerError(
            "Incorrect file format: truncated packet body"
        )
    return np.frombuffer(data, np.uint8), comp_len, raw_sizes


def _load_segment(body: "_BodyView", seg: np.ndarray):
    """Load one walked index segment ([2, k+1] absolute offsets) into a
    fixed-stride batch for ``decode_submit``: (packets uint8 [k,
    COMPRESSED_PACKET_SIZE], each packet's framed bytes at the start of
    its row and zeros after them; raw_sizes int32 [k]).  One
    ``native.expand_at`` scatter builds it, not a loop over packets."""
    data, comp_len, raw_sizes = _read_segment(body, seg)
    k = comp_len.shape[0]
    stride = COMPRESSED_PACKET_SIZE
    packets = native.expand_at(data, np.arange(k, dtype=np.int64) * stride,
                               comp_len, k * stride)
    return packets.reshape(k, stride), raw_sizes


def _load_segment_blob(body: "_BodyView", seg: np.ndarray,
                       row_bytes: int, bucket_rows: int):
    """Load one walked index segment straight into the row-aligned device
    upload blob (pipeline._PacketReader.read_batch_blob's twin): the
    segment body read IS the dense packet concatenation, so a single
    native.expand_at scatter builds the blob.  Returns (blob, row_offsets,
    comp_len, raw_sizes) for backend.decode_submit_blob."""
    data, comp_len, raw_sizes = _read_segment(body, seg)
    n = comp_len.shape[0]
    rcnt = (comp_len + row_bytes - 1) // row_bytes
    roff = np.zeros(n, np.int32)
    np.cumsum(rcnt[:-1], out=roff[1:])
    rows = int(roff[-1] + rcnt[-1]) if n else 0
    kb = -(-max(rows, 1) // bucket_rows) * bucket_rows
    blob = native.expand_at(data, roff.astype(np.int64) * row_bytes,
                            comp_len, kb * row_bytes)
    return blob, roff, comp_len, raw_sizes
