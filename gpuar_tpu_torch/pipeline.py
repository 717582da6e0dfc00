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
(``_hull_hint``; the port's kernels have one route) and
``generate_random_file``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from gpuar_tpu_torch import container, native
from gpuar_tpu_torch.config import (
    COMPRESSED_PACKET_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)
from gpuar_tpu_torch.utils.stats import CompressionInfo, ProgressMonitor, SplitTimer

# Bounded device/host memory per super-batch, like the reference's
# SM-count-sized batches (src/gpu_compressor.cpp:77-79).
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

    # --- backend interface -------------------------------------------------
    def encode_batch(self, raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """raw bytes [n] -> (packets [p, COMPRESSED_PACKET_SIZE], lengths [p])."""
        raise NotImplementedError

    def decode_batch(self, packets: np.ndarray, raw_sizes: np.ndarray) -> np.ndarray:
        """packets [p, COMPRESSED_PACKET_SIZE] -> raw [p, UNCOMPRESSED_PACKET_SIZE]."""
        raise NotImplementedError

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

        try:
            # Overlapped fill/drain: batch N+1 is read and submitted before
            # batch N's results are fetched and written, so device compute
            # overlaps host I/O (the reference's stream pipeline,
            # src/gpu_compressor.cpp:134-171).
            pending = None  # (handle, chunk_len)
            eof = False
            while not eof or pending is not None:
                handle = None
                if not eof:
                    with io:
                        chunk = fin.read(batch_bytes)
                    if chunk:
                        with process:
                            raw = np.frombuffer(chunk, dtype=np.uint8)
                            handle = (self.encode_submit(raw), len(chunk))
                    else:
                        eof = True
                if pending is not None:
                    h, chunk_len = pending
                    with process:
                        packets, lengths = self.encode_fetch(h)
                    with io:
                        body = _splice(packets, lengths)
                        fout.write(body)
                    info.compressed_file_size += len(body)
                    info.processed_uncompressed_size += chunk_len
                    monitor.update(info)
                pending = handle

            with io:
                fout.seek(0)
                header = container.FileHeader(
                    uncompressed_size=info.uncompressed_file_size,
                    compressed_size=info.compressed_file_size,
                )
                fout.write(header.to_bytes())
        finally:
            fin.close()
            fout.close()

        monitor.finish()
        info.process_time = process.total
        info.io_time = io.total
        return info

    def decompress(self, src: str | Path, dst: str | Path,
                   monitor: ProgressMonitor | None = None) -> CompressionInfo:
        monitor = monitor or ProgressMonitor(enabled=False)
        monitor.reset()
        info = CompressionInfo()
        process, io = SplitTimer(), SplitTimer()

        with io:
            actual = os.path.getsize(src)
            fin = open(src, "rb")
            head_raw = fin.read(container.HEADER_LENGTH)
        header = container.FileHeader.from_bytes(head_raw, actual_file_size=actual)
        info.uncompressed_file_size = header.uncompressed_size
        info.compressed_file_size = header.compressed_size

        with io:
            fout = open(dst, "wb")
        try:
            reader = _PacketReader(
                fin, max_raw=getattr(self, "packet_size",
                                     UNCOMPRESSED_PACKET_SIZE))
            # Backends exposing decode_blob_geometry take the compacted
            # upload path: the reader builds the row-aligned device blob
            # directly (one copy per packet), skipping the fixed-stride
            # batch and the splice/expand host passes on the submit
            # critical path (see read_batch_blob).
            blob_geom = getattr(self, "decode_blob_geometry", None)
            pending = None  # (handle, raw_sizes)
            eof = False
            while not eof or pending is not None:
                handle = None
                if not eof and blob_geom is not None:
                    with io:
                        batch = reader.read_batch_blob(
                            self.super_batch_packets, *blob_geom())
                    if batch is not None:
                        blob, roff, comp_len, raw_sizes = batch
                        with process:
                            handle = (self.decode_submit_blob(
                                blob, roff, comp_len, raw_sizes), raw_sizes)
                    else:
                        eof = True
                elif not eof:
                    with io:
                        packets, raw_sizes = reader.read_batch(
                            self.super_batch_packets
                        )
                    if packets is not None:
                        with process:
                            handle = (self.decode_submit(packets, raw_sizes),
                                      raw_sizes)
                    else:
                        eof = True
                if pending is not None:
                    h, sizes_n = pending
                    with process:
                        raw = self.decode_fetch(h)
                        body = _splice(raw, sizes_n)
                    with io:
                        fout.write(body)
                    info.processed_uncompressed_size += int(sizes_n.sum())
                    monitor.update(info)
                pending = handle
        finally:
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
        info.io_time = io.total
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


def _splice(packets: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate variable-length packets from a fixed-stride batch.

    A 1-D array is a pre-spliced body (the device-compaction path of
    parallel/codec.DeviceCodec) and passes straight through.  Returns a
    uint8 array: file.write takes it via the buffer protocol, so the
    compacted path ships a super-batch body with ZERO host copies where
    it used to pay two (.tobytes() here and in native.splice_at)."""
    if packets.ndim == 1:
        return np.ascontiguousarray(packets)
    if packets.shape[0] == 0:
        return np.empty(0, np.uint8)
    if (packets.flags.c_contiguous and lengths[0] == packets.shape[1]
            and np.all(lengths == lengths[0])):
        # Every packet fills its stride (every decompress batch except
        # the file tail): the concatenation is the buffer itself — a
        # reshaped VIEW, not a whole-body memcpy on the drive loop's
        # process path.
        return packets.reshape(-1)
    return native.splice(packets, lengths)


class _PacketReader:
    """Block-buffered framed-packet reader: one read(2) per ~8 MiB
    instead of two per packet (the reference reads header-then-body per
    packet, src/gpu_compressor.cpp:299-310 — ~2.6 M syscalls on a 10 GB
    archive; the block walk keeps the same validation)."""

    def __init__(self, fin, block_size: int = 8 << 20,
                 max_raw: int = UNCOMPRESSED_PACKET_SIZE):
        self._fin = fin
        self._block = block_size
        # Raw-size validation bound: the BACKEND's packet geometry (a
        # configurable-packet_size backend must reject raw sizes its
        # kernels cannot decode, not just ones over the global default).
        self._max_raw = max_raw
        self._buf = b""
        self._pos = 0
        self._eof = False

    def _avail(self) -> int:
        return len(self._buf) - self._pos

    def _fill(self, need: int) -> int:
        """Ensure `need` bytes are buffered past the cursor (or EOF);
        returns the bytes available."""
        if self._avail() >= need or self._eof:
            return self._avail()
        chunks = [self._buf[self._pos:]]
        got = len(chunks[0])
        while got < need:
            blk = self._fin.read(self._block)
            if not blk:
                self._eof = True
                break
            chunks.append(blk)
            got += len(blk)
        self._buf = b"".join(chunks)
        self._pos = 0
        return len(self._buf)

    def read_batch(self, max_packets: int):
        """Up to max_packets framed packets as a fixed-stride batch.

        Returns (packets [p, COMPRESSED_PACKET_SIZE] uint8, raw_sizes [p])
        or (None, None) at EOF.
        """
        packets = np.zeros((max_packets, COMPRESSED_PACKET_SIZE),
                           dtype=np.uint8)
        raw_sizes = np.zeros(max_packets, dtype=np.int32)
        count = 0
        while count < max_packets:
            have = self._fill(PACKET_HEADER_LENGTH)
            if have == 0:
                break
            if have < PACKET_HEADER_LENGTH:
                raise container.ContainerError(
                    "Incorrect file format: truncated packet header"
                )
            total, raw = container.packet_sizes(
                self._buf[self._pos: self._pos + PACKET_HEADER_LENGTH]
            )
            container.validate_packet_header(total, raw, self._max_raw)
            if self._fill(total) < total:
                raise container.ContainerError(
                    "Incorrect file format: truncated packet body"
                )
            packets[count, :total] = np.frombuffer(
                self._buf, np.uint8, total, self._pos)
            raw_sizes[count] = raw
            self._pos += total
            count += 1
        if count == 0:
            return None, None
        return packets[:count], raw_sizes[:count]

    def read_batch_blob(self, max_packets: int, row_bytes: int,
                        bucket_rows: int):
        """Up to max_packets framed packets as a compacted upload blob.

        No fixed-stride batch and no whole-body host pass: each packet's
        bytes are copied ONCE, straight from the block buffer into its
        row-aligned slot of the device upload blob, which K2 reads in
        place at per-packet offsets.  Mirrors the reference's overlapped
        fill/drain intent (src/gpu_compressor.cpp:287-343).

        Returns (blob [kb*row_bytes] uint8 with kb a bucket_rows
        multiple, row_offsets [p] i32, comp_len [p] i32, raw_sizes [p]
        i32) or None at EOF.  Validation matches read_batch.
        """
        rows_pp = -(-COMPRESSED_PACKET_SIZE // row_bytes)
        cap_rows = max_packets * rows_pp + bucket_rows
        blob = np.zeros(cap_rows * row_bytes, dtype=np.uint8)
        roff = np.zeros(max_packets, dtype=np.int32)
        comp_len = np.zeros(max_packets, dtype=np.int32)
        raw_sizes = np.zeros(max_packets, dtype=np.int32)
        count = 0
        rows = 0
        while count < max_packets:
            have = self._fill(PACKET_HEADER_LENGTH)
            if have == 0:
                break
            if have < PACKET_HEADER_LENGTH:
                raise container.ContainerError(
                    "Incorrect file format: truncated packet header"
                )
            total, raw = container.packet_sizes(
                self._buf[self._pos: self._pos + PACKET_HEADER_LENGTH]
            )
            container.validate_packet_header(total, raw, self._max_raw)
            if self._fill(total) < total:
                raise container.ContainerError(
                    "Incorrect file format: truncated packet body"
                )
            start = rows * row_bytes
            blob[start: start + total] = np.frombuffer(
                self._buf, np.uint8, total, self._pos)
            roff[count] = rows
            comp_len[count] = total
            raw_sizes[count] = raw
            rows += -(-total // row_bytes)
            self._pos += total
            count += 1
        if count == 0:
            return None
        kb = -(-max(rows, 1) // bucket_rows) * bucket_rows
        return (blob[: kb * row_bytes], roff[:count], comp_len[:count],
                raw_sizes[:count])


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
