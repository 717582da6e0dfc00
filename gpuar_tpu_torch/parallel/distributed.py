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
  offset.

Every process needs the same shared filesystem.  The pure planning
helpers and segment loaders are the JAX module's own (that module imports
JAX only inside its collective seams, so this one stays free of JAX).
Its five seams are replaced here with ``torch.distributed`` on **gloo**:
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

from gpuar_tpu import container
from gpuar_tpu.config import UNCOMPRESSED_PACKET_SIZE
from gpuar_tpu.parallel.distributed import (
    _BodyView,
    _IterPrefetcher,
    _load_segment_blob,
    exclusive_scan,
    host_ranges,
    walk_packet_index_chunks,
)
from gpuar_tpu.pipeline import _splice
from gpuar_tpu.utils.stats import CompressionInfo, ProgressMonitor, SplitTimer


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

    The local codec work goes to a per-process backend with the
    compacted-blob decode interface (``decode_blob_geometry``,
    ``decode_submit_blob``): by default GPUCompressor on this process's
    local GPUs.
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
                    with io:
                        chunk = fin.read(min(batch, todo))
                    todo -= len(chunk)
                    if chunk:
                        with process:
                            raw = np.frombuffer(chunk, dtype=np.uint8)
                            handle = (self.backend.encode_submit(raw),
                                      len(chunk))
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
            blob_geom = self.backend.decode_blob_geometry()
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
                        with io:
                            ublob, roff, clen, raw_sizes = _load_segment_blob(
                                body, seg, *blob_geom)
                        with process:
                            handle = (self.backend.decode_submit_blob(
                                ublob, roff, clen, raw_sizes), raw_sizes,
                                int(seg[1, 0]), int(seg[1, -1]))
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
