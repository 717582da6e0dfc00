"""The port's benchmark on the card (the counterpart of ``bench.py``).

    python -m gpuar_tpu_torch.bench [--cell NAME] [--mib N] [--workdir DIR]

The command of ``BENCHMARK.json``.  Each cell is a corpus coded as a file
through the port's main path on one host (``CELLS``, its corpus's kind in
``CORPUS``); with no ``--cell`` every cell runs in turn.  ``--mib N``
cuts the cell's corpus to N MiB.  Files go to a temporary directory under
``OUT``, or under ``--workdir DIR`` (a diagnostic: the same cell on
another filesystem); before any run, the command fails unless its
filesystem has ``DISK_FILES`` times the largest corpus free.

Every run that writes a file writes a new one (``Outputs``): the corpus
is written once, and each compress writes an archive and each
decompress its round trip at paths that do not exist when the run
starts, the decompress reading the archive its own compress wrote.  A
user who writes a new archive pays no truncation of an old one, so no
run pays it.  The previous pair is unlinked between runs, outside every
timed span; the unlinks' seconds are reported under ``setup`` and
``detail`` and in no metric.  For each cell, in this order:

  1. set-up: the corpus, the CUDA context, the kernels' ``nvcc`` build and
     load (``_kernels.load``), the host codec's g++ build and load
     (``native.load``), and the cold first run: the first
     ``GPUCompressor().compress`` and ``.decompress`` of the file in the
     process; the drive loops' super-batch (GPUCompressor's, sized from
     the card), the work directory's filesystem type and free bytes, the
     unlinks' count and seconds, and the seconds of steps 2 to 4 and of
     the whole cell, are reported with them;
  2. correctness, before any number is printed: the corpus is cut as the
     drive loops cut it, into one card's batch (``launch_packets``: 4224
     packets on the H100); on each batch, K1's packets (their first
     ``lengths[i]`` bytes) and lengths equal the port's golden codec's
     (``native.encode_batch``) for every packet, ``GOLDEN_SAMPLE`` a
     ``GOLDEN_BYTES`` of corpus, spread over the batches (the first, the
     last and a seeded draw of each), equal the executable
     specification's (``ops/golden.py``, which shares no code with the
     kernels or the native codec), and K2 decodes K1's packets back to the
     batch; the GPU archive is byte-equal to ``HostCompressor``'s and, at
     a cell's full size, its sha256 equals ``ARCHIVE_SHA256`` (the JAX
     package's archive of the corpus, held there by the tests); the md5
     of the decompressed file equals the corpus's.  These hold the cold
     run's archive and round trip, and again, after step 8, the last
     timed run's.  A failure exits non-zero and prints no metric;
  3. the kernel layer: K1 (``ops/encode.py encode_batch``) and K2
     (``ops/decode.py decode_blob``, on the batch's packets as the dense
     blob the drive loop reads: back to back, as they lie in the file) on
     each of those batches already on the card, the launches the main
     path makes, timed by CUDA events (a
     warm-up, then 5 timings; the least is the figure, every one is
     kept), and the corpus bytes over the sum of the least K1 and K2
     times (``kernel_gbps``);
  4. the baseline: the port's own host codec, ``HostCompressor(threads=0)``
     on every core, on the same file (``HOST_RUNS`` runs, all bytes over
     all seconds); ``vs_baseline`` is the GPU round trip's rate over the
     host's;
  5. on a CUDA device, one stage-timed compress and decompress
     (``stages.stage_run``): each thread's stages by the host clock, the
     device stages by CUDA events on the same clock, the card's idle
     gaps;
  6. end to end: warm runs of compress then decompress of the file on
     local disk, in turn, each pair to new files, until each verb has at
     least ``RUNS`` runs and
     ``--seconds`` (``WINDOW_S``) of timed wall time, with no hook in
     place.  Each verb's metric is all its bytes over all its seconds;
     its spread is the inter-quartile range of the same rate over
     ``BLOCKS`` consecutive blocks of the runs, over their median.  The
     per-run median and quartiles, the means of ``CompressionInfo``'s
     ``process_time`` and ``io_time``, and each block's mean of
     /proc/meminfo's ``Dirty`` and ``Writeback`` (read after each run)
     are reported beside it;
  7. a second stage-timed compress and decompress, after the window: the
     stage metrics (``STAGE_METRICS``, the card's busy share among them)
     are the mean of the two runs, and both runs and each metric's two
     readings are printed, so drift within the window shows;
  8. one traced compress and decompress (torch.profiler): the card's time
     per kernel and copy, and the trace's records of the codec kernels
     against the launches the run made (a trace short of them loses
     busy time).

Every line printed carries the card's name and power limit (nvidia-smi);
each verb's ``breakdown`` line gives the traced run's longest device
operations and the second stage run's longest idle gaps of the card,
with what each thread was doing in them, and its idle seconds by the
loop's stage.  A cell's result is refused (the command exits non-zero)
if JAX, jaxlib, flax or the JAX package is loaded in the process
(``refuse_foreign``).  The last line is one JSON object of the cell:
``correct``, the metrics of BENCHMARK.json under their names, ``setup``,
``device`` (backend "cuda", card, device count), ``layers`` (which
layer each number times), ``breakdown`` and ``detail`` (per-batch,
per-run and per-stage times).  Without a CUDA device the command fails
and says so: there is no CPU fallback and no replay.  The functions take
the device they run on, so the tests drive them on the CPU, where the
kernels' plain versions run and no time is reported.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gpuar_tpu_torch.bench import OUT, corpora, md5, stages
from gpuar_tpu_torch.config import UNCOMPRESSED_PACKET_SIZE as P
from gpuar_tpu_torch.pipeline import DEFAULT_SUPER_BATCH_PACKETS

RUNS = 7          # at least this many timed warm runs of each verb,
WINDOW_S = 10.0   # and at least this many timed seconds of each
BLOCKS = 5        # consecutive blocks of the runs, for the spread
HOST_RUNS = 3     # timed runs of the host baseline
KERNEL_REPS = 5
GOLDEN_SAMPLE = 256   # packets held to ops/golden.py a GOLDEN_BYTES of corpus
GOLDEN_BYTES = DEFAULT_SUPER_BATCH_PACKETS * P   # 64 MiB
DEVICE_OPS = 6        # device operations a breakdown lists
VERBS = ("compress", "decompress")

# cell -> its corpus's bytes at full size (``corpus``; why each cell:
# BENCHMARK.json).
CELLS = {"random_64m": 64 << 20, "enwik8_proxy_100m": 100_000_000,
         "random_1g": 1 << 30}
# cell -> the kind of its corpus: "random" (``corpora.random_bytes``, seed
# 0xBE7C) or "enwik" (``corpora.generate``, the enwik8 proxy).  Every cell
# is listed; ``corpus`` refuses one that is not.
CORPUS = {"random_64m": "random", "enwik8_proxy_100m": "enwik",
          "random_1g": "random"}
# cell -> the sha256 of its archive at full size: the JAX package's
# HostCompressor archive of the corpus (tests/test_torch_bench.py computes
# it and holds it to these values).
ARCHIVE_SHA256 = {
    "random_64m":
        "ba6042223b988998dbf0db530cb7e3c0765843b2747fbc7c81b61ef284f3f3b6",
    "enwik8_proxy_100m":
        "8165e628bea1bbd251e9e2d524354bb899031b66e06e8229877802528c1e0b52",
    "random_1g":
        "2334272c57c8acd8ad8541275d69e5ef90a0838e69ebe8a23f5fc65643c5eabb",
}
# The work directory must have this many times the corpus free: at most
# six files of about its size are there at once (the source, the host
# archive the last check holds, the last timed run's archive and round
# trip, one more run's pair), and room for one more.
DISK_FILES = 7

LAYERS = {
    "compress_gbps": "end to end: file bytes of every warm run / their "
                     "wall s, GPUCompressor().compress (file read, upload, "
                     "K1, G1's gather of the body, download, write)",
    "decompress_gbps": "end to end: the same for "
                       "GPUCompressor().decompress",
    "compress_process_s": "drive loop: CompressionInfo.process_time of a "
                          "compress, mean of the warm runs (submit and "
                          "fetch on the loop's thread, the device work it "
                          "waits for)",
    "compress_io_s": "drive loop: CompressionInfo.io_time of a compress, "
                     "mean (file read on the reader thread, write on the "
                     "writer thread; the threads overlap, so io "
                     "plus process may exceed the wall)",
    "decompress_process_s": "drive loop: process_time of a decompress, "
                            "mean (submit, fetch and splice on the loop's "
                            "thread)",
    "decompress_io_s": "drive loop: io_time of a decompress, mean (read "
                       "and blob build on the reader thread, write on the "
                       "writer thread; io plus process may exceed the "
                       "wall)",
    "k1_ms": "kernel: K1 on batch 0 of the drive loops' launches (one "
             "card's batch, setup.kernel_batch_packets) already on the "
             "card, CUDA events, least of 5",
    "k2_ms": "kernel: K2 on batch 0's compacted packets on the card, CUDA "
             "events, least of 5",
    "kernel_gbps": "kernel: corpus bytes / sum over the loops' launches of "
                   "the least K1 + K2 ms",
    "vs_baseline": "end to end: GPU round trip rate / "
                   "HostCompressor(threads=0) round trip rate, same file, "
                   "each all bytes over all seconds",
    "compress_device_busy_share": "device: the card's busy share of a "
                                  "stage-timed compress's wall (the union "
                                  "of its device stages / its wall), mean "
                                  "of the two runs; each device stage "
                                  "starts where its call starts to "
                                  "enqueue, so the share holds that "
                                  "enqueue",
    "decompress_device_busy_share": "device: the same for a stage-timed "
                                    "decompress",
    "compress_lead_in_s": "stages: s from a compress's start to the start "
                          "of its first device stage (the files' open and "
                          "the first batch's read, which nothing "
                          "overlaps); mean of the two stage-timed runs, "
                          "before and after the window",
    "decompress_lead_in_s": "stages: the same for a decompress (the first "
                            "batch's read and walk)",
    "compress_read_s": "stages: the reader thread's file read s in a "
                       "compress, mean of the two stage-timed runs",
    "decompress_read_s": "stages: the reader thread's file read s in a "
                         "decompress, mean",
    "decompress_walk_s": "stages: the reader thread's header walk s "
                         "(native.walk_packets) in a decompress, mean",
    "compress_write_s": "stages: the writer thread's write s in a "
                        "compress, mean",
    "decompress_write_s": "stages: the writer thread's write s in a "
                          "decompress, mean",
    "compress_splice_s": "stages: the loop thread's splice s "
                         "(native.splice_at) in a compress, mean; 0 since "
                         "G1 gathers the body on the card",
    "compress_device_s": "stages: the union of a compress's device stages "
                         "(H2D + K1 + G1's gather, D2H; CUDA events on the "
                         "host clock), s, mean",
    "decompress_device_s": "stages: the union of a decompress's device "
                           "stage (H2D + K2 + D2H), s, mean",
}
# stage metric -> (verb, thread label or None for the run's own number,
# the stage or the number): read from ``stages.summarize``.
STAGE_METRICS = {
    "compress_lead_in_s": ("compress", None, "lead_in_s"),
    "decompress_lead_in_s": ("decompress", None, "lead_in_s"),
    "compress_read_s": ("compress", "reader", "read"),
    "decompress_read_s": ("decompress", "reader", "read"),
    "decompress_walk_s": ("decompress", "reader", "walk"),
    "compress_write_s": ("compress", "writer", "write"),
    "decompress_write_s": ("decompress", "writer", "write"),
    "compress_splice_s": ("compress", "main", "splice"),
    "compress_device_s": ("compress", None, "device_s"),
    "decompress_device_s": ("decompress", None, "device_s"),
    "compress_device_busy_share": ("compress", None, "device_share"),
    "decompress_device_busy_share": ("decompress", None, "device_share"),
}


class Failure(SystemExit):
    """A correctness check failed: exit non-zero, print no metric."""

    def __init__(self, msg: str):
        super().__init__(f"gpuar_tpu_torch.bench: {msg}")


# Packages that must not be loaded in a measured process: the port is
# measured without JAX and without the JAX package.
FOREIGN = ("jax", "jaxlib", "flax", "gpuar_tpu")


def foreign_modules(modules=None) -> list[str]:
    """The names in ``modules`` (default ``sys.modules``) that are one of
    FOREIGN or a submodule of one, sorted."""
    names = list(sys.modules if modules is None else modules)
    return sorted(m for m in names if m.split(".")[0] in FOREIGN)


def refuse_foreign(modules=None) -> None:
    """Raises Failure if ``foreign_modules(modules)`` names any."""
    loaded = foreign_modules(modules)
    if loaded:
        raise Failure(f"{', '.join(loaded[:5])} loaded in the process (of "
                      f"{len(loaded)} such modules): the port is measured "
                      "without JAX and the JAX package, so no result is "
                      "reported")


def corpus(cell: str, size: int) -> bytes:
    """The cell's corpus of ``size`` bytes, of the kind ``CORPUS`` gives it:
    random bytes (seed 0xBE7C), or the enwik8 proxy, cached at its pinned
    sizes.  Raises KeyError for a cell ``CORPUS`` does not list."""
    kind = CORPUS.get(cell)
    if kind == "random":
        return corpora.random_bytes(size)
    if kind == "enwik":
        return corpora.cached("enwik", size)
    raise KeyError(f"cell {cell!r} has no corpus kind in CORPUS")


def batch_packets(size: int, packets: int) -> list[int]:
    """The packets of each super-batch GPUCompressor cuts a file of
    ``size`` bytes into (super-batches of ``packets`` P-byte packets, the
    last packet ragged)."""
    step = packets * P
    return [-(-min(step, size - lo) // P) for lo in range(0, size, step)]


def batches(data: bytes, packets: int):
    """The corpus as GPUCompressor cuts it (``batch_packets``), each batch
    zero-padded -> [(raw [n, P] uint8, sizes [n] int32, the batch's
    bytes)]."""
    raw = np.frombuffer(data, np.uint8)
    step = packets * P
    out = []
    for lo, n in zip(range(0, raw.size, step),
                     batch_packets(raw.size, packets)):
        chunk = raw[lo: lo + step]
        rows = np.zeros((n, P), np.uint8)
        rows.reshape(-1)[: chunk.size] = chunk
        sizes = np.full(n, P, np.int32)
        sizes[-1] = chunk.size - (n - 1) * P
        out.append((rows, sizes, chunk))
    return out


def launch_packets(gpu) -> int:
    """One card's batch of ``gpu``'s drive loops, the kernel launch they
    make: its super-batch over its devices where the card sized it (4224
    packets on the H100), else DEFAULT_SUPER_BATCH_PACKETS."""
    if not gpu.batch_from_card:
        return DEFAULT_SUPER_BATCH_PACKETS
    return gpu.super_batch_packets // len(gpu.codec.codecs)


def golden_total(size: int, per: int = GOLDEN_SAMPLE) -> int:
    """Packets of a ``size``-byte corpus to hold to the executable
    specification: ``per`` a GOLDEN_BYTES, the last part counting
    whole."""
    return per * -(-size // GOLDEN_BYTES)


def golden_quota(counts: list[int], total: int) -> list[int]:
    """``total`` spread over batches of ``counts`` packets as evenly as
    they allow, none past its batch's count -> each batch's share (their
    sum is ``total``, or every packet where there are fewer)."""
    quota, left = [0] * len(counts), total
    order = sorted(range(len(counts)), key=counts.__getitem__)
    for k, i in enumerate(order):
        quota[i] = min(counts[i], -(-left // (len(counts) - k)))
        left -= quota[i]
    return quota


def check_packets(b: int, packets: np.ndarray, lengths: np.ndarray,
                  want: np.ndarray, want_len: np.ndarray) -> None:
    """Every packet's first lengths[i] bytes and its length equal the golden
    codec's; raises Failure naming the first packet that differs."""
    bad = np.nonzero(lengths != want_len)[0]
    if bad.size == 0:
        width = min(packets.shape[1], want.shape[1])
        keep = np.arange(width)[None, :] < want_len[:, None]
        diff = (packets[:, :width] != want[:, :width]) & keep
        bad = np.nonzero(diff.any(axis=1))[0]
    if bad.size:
        i = int(bad[0])
        raise Failure(f"super-batch {b} packet {i}: K1 differs from the "
                      f"golden codec (length {int(lengths[i])}, golden "
                      f"{int(want_len[i])}; {bad.size} packets differ)")


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """k of the packet indices 0..n-1 (every one if n <= k): the first,
    the last (the ragged one) and k - 2 drawn without replacement from a
    generator seeded with ``seed``, in order."""
    if n <= k:
        return np.arange(n)
    rest = np.random.default_rng(seed).choice(np.arange(1, n - 1), k - 2,
                                              replace=False)
    return np.sort(np.concatenate([[0, n - 1], rest]))


def golden_packets(chunks: list[bytes]) -> list[bytes]:
    """``ops/golden.encode_packet`` of each chunk.  A packet takes the
    specification about 0.1 s, so past a few packets the work is spread
    over processes on every core."""
    from gpuar_tpu_torch.ops import golden

    if len(chunks) <= 8:
        return [golden.encode_packet(c) for c in chunks]
    workers = min(os.cpu_count() or 1, -(-len(chunks) // 8))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        return list(ex.map(golden.encode_packet, chunks, chunksize=8))


def check_golden(picked: list[tuple[int, int, bytes, bytes]]) -> None:
    """[(super-batch, packet, K1's packet, raw chunk)]: each K1 packet
    equals the executable specification's; raises Failure naming the
    first that differs."""
    want = golden_packets([raw for _, _, _, raw in picked])
    for (b, i, got, _), w in zip(picked, want):
        if got != w:
            raise Failure(f"super-batch {b} packet {i}: K1 differs from the "
                          f"executable specification, ops/golden.py "
                          f"(length {len(got)}, specification {len(w)})")


def kernel_layer(data: bytes, device: torch.device, host, packets: int,
                 reps: int = KERNEL_REPS,
                 golden_sample: int = GOLDEN_SAMPLE) -> list[dict]:
    """K1 then K2 on each super-batch of ``packets`` packets on
    ``device``: every packet held to the port's golden codec
    (``host.encode_batch``), ``golden_sample`` a GOLDEN_BYTES of corpus
    (``golden_quota`` of ``golden_total``) to the executable
    specification, K2's output (on the dense blob of K1's packets, the
    drive loop's form) to the batch; on a CUDA device also timed
    -> [{"packets", "bytes", "comp_bytes" (the packets' total length),
    "golden_sampled", and on CUDA "k1_ms", "k2_ms" (the least) and
    "k1_reps", "k2_reps"}]."""
    from gpuar_tpu_torch import native
    from gpuar_tpu_torch.ops import decode, encode

    rows_out, picked = [], []
    cut = batches(data, packets)
    quota = golden_quota([rows.shape[0] for rows, _, _ in cut],
                         golden_total(len(data), golden_sample))
    for b, (rows, sizes, chunk) in enumerate(cut):
        d = torch.from_numpy(rows).to(device)
        s = torch.from_numpy(sizes).to(device)
        pk, ln = encode.encode_batch(d, s)
        want, want_len = host.encode_batch(chunk)
        got, lengths = pk.cpu().numpy(), ln.cpu().numpy()
        check_packets(b, got, lengths, want, want_len)
        idx = sample(rows.shape[0], quota[b], seed=b)
        picked += [(b, int(i), got[i, : lengths[i]].tobytes(),
                    chunk[i * P: (i + 1) * P].tobytes()) for i in idx]
        blob = torch.from_numpy(native.splice(got, lengths)).to(device)
        offs = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(lengths[:-1], dtype=np.int64)])).to(device)
        if not torch.equal(decode.decode_blob(blob, offs, s), d):
            raise Failure(f"super-batch {b}: K2 does not return the batch")
        row = {"packets": int(rows.shape[0]), "bytes": int(chunk.size),
               "comp_bytes": int(want_len.sum()),
               "golden_sampled": int(idx.size)}
        if device.type == "cuda":
            from gpuar_tpu_torch.probes import time_each

            with torch.cuda.device(device):
                k1 = time_each(lambda: encode.encode_batch(d, s), reps)
                k2 = time_each(lambda: decode.decode_blob(blob, offs, s),
                               reps)
            row.update(k1_ms=min(k1), k2_ms=min(k2), k1_reps=k1, k2_reps=k2)
        rows_out.append(row)
        del d, s, pk, ln, blob, offs
    del cut
    check_golden(picked)
    return rows_out


def _timed(fn, *args):
    t = time.perf_counter()
    out = fn(*args)
    return time.perf_counter() - t, out


class Outputs:
    """The outputs of a cell's runs in ``work``: each ``pair`` is an
    archive and its round trip at paths that do not exist yet, so no run
    truncates an earlier run's file; ``drop`` unlinks files between runs
    and keeps the seconds each call took (``unlink_s``)."""

    def __init__(self, work: Path):
        self.work, self.made, self.unlink_s = work, 0, []

    def pair(self, kind: str = "gpu") -> tuple[Path, Path]:
        """The next ``{kind}_{k}.gip`` and ``{kind}_back_{k}.bin``; raises
        Failure if either exists."""
        k, self.made = self.made, self.made + 1
        gip = self.work / f"{kind}_{k}.gip"
        back = self.work / f"{kind}_back_{k}.bin"
        for path in (gip, back):
            if path.exists():
                raise Failure(f"{path} exists before the run that writes it")
        return gip, back

    def drop(self, *paths: Path) -> None:
        t = time.perf_counter()
        for path in paths:
            path.unlink()
        self.unlink_s.append(time.perf_counter() - t)


def device_trace(fn):
    """One call of fn under torch.profiler -> (wall s, device busy s,
    {kernel or copy name: [device ms, count]}).  Busy is the union of the
    card's kernel and copy intervals; the profiler adds host overhead to
    the wall time, so the end-to-end metrics come from untraced runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # acc_events: keep every event of the run (the profiler otherwise
    # clears them at the end of each cycle).
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    per_name: dict[str, list] = {}
    for e in events:
        acc = per_name.setdefault(e.name[:60], [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    return wall, busy / 1e6, per_name


# The codec kernels' launch counters (``_kernels.LAUNCHES``) -> the part of
# their name in a trace's records.
TRACE_NAMES = {"encode": "encode_kernel", "gather": "gather_body_kernel",
               "decode": "decode_kernel<false>",
               "decode_debug": "decode_kernel<true>"}


def trace_kernels(per_name: dict, launches: dict) -> dict:
    """A traced run's records of the codec kernels (``device_trace``'s
    names) against the launches the run made (the growth of
    ``_kernels.LAUNCHES``) -> {kernel: {"records", "launches"}} for each
    kernel launched.  A trace with fewer records than launches lost
    some: its busy seconds under-read."""
    return {k: {"records": sum(n for name, (_, n) in per_name.items()
                               if TRACE_NAMES[k] in name),
                "launches": made}
            for k, made in launches.items() if made}


def traced(fn, *args) -> tuple:
    """``device_trace`` of ``fn(*args)`` and the codec kernels' launches
    it made."""
    from gpuar_tpu_torch.ops import _kernels

    before = dict(_kernels.LAUNCHES)
    trace = device_trace(lambda: fn(*args))
    return trace, {k: n - before[k] for k, n in _kernels.LAUNCHES.items()}


def check_archive(src: Path, gip: Path, back: Path, host_gip: Path,
                  want_md5: str, want_sha256: str | None = None) -> None:
    """The GPU archive equals the host's and, where given, its pinned
    sha256; the decompressed file's md5 is the corpus's."""
    if not filecmp.cmp(gip, host_gip, shallow=False):
        raise Failure(f"{gip.name}: the GPU archive differs from "
                      "HostCompressor's")
    if want_sha256 is not None and md5(gip, "sha256") != want_sha256:
        raise Failure(f"{gip.name}: the archive's sha256 differs from its "
                      f"pin {want_sha256} (the JAX package's archive)")
    if md5(back) != want_md5:
        raise Failure(f"{back.name}: the decompressed file's md5 differs "
                      f"from {src.name}'s")


def fs_type(path, mounts: str | None = None) -> str:
    """The type of the filesystem that holds ``path``: that of the longest
    mount point in /proc/mounts (``mounts``, its text, in place of the
    file) that contains it; the last such line wins."""
    if mounts is None:
        mounts = Path("/proc/mounts").read_text()
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    for line in mounts.splitlines():
        f = line.split()
        if len(f) < 3:
            continue
        mnt = f[1].replace("\\040", " ")
        inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
        if inside and len(mnt) >= len(best):
            best, kind = mnt, f[2]
    return kind


def disk_room(path: Path, need: int) -> dict:
    """The work directory's filesystem type and free bytes ->
    {"work_fs", "work_free_bytes"}; raises Failure if fewer than ``need``
    bytes are free."""
    free = shutil.disk_usage(path).free
    fs = fs_type(path)
    if free < need:
        raise Failure(f"the work directory {path} ({fs}) has {free} B free; "
                      f"this run needs {need} B ({DISK_FILES} times the "
                      "corpus: the source, the host archive, two runs' "
                      "archives and round trips, and room for one more)")
    return {"work_fs": fs, "work_free_bytes": free}


# /proc/meminfo's fields read after each timed run (kB): the page cache's
# dirty pages and those under write-back.
MEMINFO = ("Dirty", "Writeback")


def meminfo(text: str | None = None) -> dict:
    """``MEMINFO``'s fields of /proc/meminfo (``text``, its text, in place
    of the file) -> {field: kB}."""
    if text is None:
        text = Path("/proc/meminfo").read_text()
    out = {}
    for line in text.splitlines():
        key, _, rest = line.partition(":")
        if key in MEMINFO:
            out[key] = int(rest.split()[0])
    return out


def quartiles(x) -> list[float]:
    return [float(q) for q in np.percentile(np.asarray(x, np.float64),
                                            [25, 50, 75])]


def window(size: int, seconds: list[float], blocks: int = BLOCKS,
           mem: list[dict] | None = None) -> dict:
    """One verb's timed runs of ``size`` bytes -> "gbps" (every run's bytes
    over every run's seconds), "blocks" (the same rate over each of
    ``blocks`` consecutive blocks of runs), "spread" (the blocks'
    inter-quartile range over their median) and "runs" (the per-run
    rates' quartiles).  ``mem``, a ``meminfo`` reading after each run,
    adds "dirty_kb" and "writeback_kb": each block's mean reading."""
    t = np.asarray(seconds, np.float64)
    n = min(blocks, t.size)
    rate = [p.size * size / p.sum() / 1e9 for p in np.array_split(t, n)]
    q = quartiles(rate)
    out = {"gbps": t.size * size / t.sum() / 1e9, "blocks": rate,
           "spread": (q[2] - q[0]) / q[1],
           "runs": quartiles(size / t / 1e9)}
    for key in MEMINFO if mem is not None else ():
        kb = np.asarray([m[key] for m in mem], np.float64)
        out[f"{key.lower()}_kb"] = [float(b.mean())
                                    for b in np.array_split(kb, n)]
    return out


def bench_cell(cell: str, data: bytes, work: Path, gpu, host,
               device: torch.device, runs: int = RUNS,
               seconds: float = WINDOW_S, host_runs: int = HOST_RUNS,
               want_sha256: str | None = None,
               golden_sample: int = GOLDEN_SAMPLE) -> dict:
    """One cell on ``data``: the checks, and on a CUDA device the times
    (module docstring, steps 1-8).  ``gpu`` is the GPUCompressor under
    test, ``host`` a HostCompressor; files go to ``work``, each run's to
    new paths (``Outputs``); ``want_sha256`` is the archive's pin, if
    any.  Raises Failure on a failed check."""
    cuda = device.type == "cuda"
    size = len(data)
    src = work / "in.bin"
    src.write_bytes(data)
    want_md5 = md5(src)
    out = Outputs(work)

    # The cold first run (set-up), then its checks.
    gip, back = out.pair()
    cold_c, _ = _timed(gpu.compress, src, gip)
    cold_d, _ = _timed(gpu.decompress, gip, back)
    launch = launch_packets(gpu)
    t_checks, kernels = _timed(lambda: kernel_layer(
        data, device, host, packets=launch, golden_sample=golden_sample))
    host_c, host_d, host_pair = [], [], ()
    t_base = time.perf_counter()
    for _ in range(host_runs):
        if host_pair:
            out.drop(*host_pair)
        host_gip, host_back = host_pair = out.pair("host")
        host_c.append(_timed(host.compress, src, host_gip)[0])
        host_d.append(_timed(host.decompress, host_gip, host_back)[0])
    t_base = time.perf_counter() - t_base
    if md5(host_back) != want_md5:
        raise Failure("the host codec does not round-trip the corpus")
    check_archive(src, gip, back, host_gip, want_md5, want_sha256)
    # The host archive stays for the check after the window.
    out.drop(gip, back, host_back)

    # A stage-timed run of each verb before the window and one after it,
    # each with its hooks undone before it returns.
    staged = {verb: [] for verb in VERBS}

    def stage_runs():
        if cuda:
            gip, back = out.pair()
            for verb, files in zip(VERBS, ((src, gip), (gip, back))):
                staged[verb].append(stages.stage_run(gpu, verb, *files))
            out.drop(gip, back)

    stage_runs()
    # Warm runs, compress then decompress in turn, until each verb has
    # ``runs`` runs and ``seconds`` of them; the page cache's dirty and
    # write-back kB are read after each run.  The last pair stays for the
    # check after the window.
    t_c, t_d, infos, mem_c, mem_d = [], [], [], [], []
    last = ()
    while len(t_c) < runs or min(sum(t_c), sum(t_d)) < seconds:
        if last:
            out.drop(*last)
        gip, back = last = out.pair()
        tc, ci = _timed(gpu.compress, src, gip)
        mem_c.append(meminfo())
        td, di = _timed(gpu.decompress, gip, back)
        mem_d.append(meminfo())
        t_c.append(tc)
        t_d.append(td)
        infos.append((ci, di))
    stage_runs()
    if cuda:
        # One traced run of each verb, after the timed ones, with the
        # launches it made.
        gip, back = out.pair()
        traces = {verb: traced(getattr(gpu, verb), *files)
                  for verb, files in zip(VERBS, ((src, gip), (gip, back)))}
        out.drop(gip, back)
    gip, back = last
    check_archive(src, gip, back, host_gip, want_md5, want_sha256)
    ratio = gip.stat().st_size / size if size else 0.0

    from gpuar_tpu_torch.bench.corpora import order0_bits

    result = {"cell": cell, "correct": True, "bytes": size,
              "packets": sum(k["packets"] for k in kernels),
              "super_batches": len(kernels), "ratio": ratio,
              "order0_bits_per_byte": order0_bits(data),
              "checks": {"golden_sampled": sum(k["golden_sampled"]
                                               for k in kernels),
                         "archive_pinned": want_sha256 is not None},
              "runs": len(t_c)}
    if not cuda:
        return result
    wc, wd = window(size, t_c, mem=mem_c), window(size, t_d, mem=mem_d)
    host_rt = size / (np.mean(host_c) + np.mean(host_d)) / 1e9
    gpu_rt = size / (np.mean(t_c) + np.mean(t_d)) / 1e9
    k_total = sum(k["k1_ms"] + k["k2_ms"] for k in kernels)
    readings = stage_readings(staged)
    result.update({
        "unit": "GB/s",
        "compress_gbps": wc["gbps"], "decompress_gbps": wd["gbps"],
        # The blocks' inter-quartile range as a share of their median:
        # the spread that sets each metric's bound in BENCHMARK.json.
        "compress_gbps_spread": wc["spread"],
        "decompress_gbps_spread": wd["spread"],
        "window_s": [float(sum(t_c)), float(sum(t_d))],
        "compress_process_s": float(np.mean(
            [c.process_time for c, _ in infos])),
        "compress_io_s": float(np.mean([c.io_time for c, _ in infos])),
        "decompress_process_s": float(np.mean(
            [d.process_time for _, d in infos])),
        "decompress_io_s": float(np.mean([d.io_time for _, d in infos])),
        "k1_ms": kernels[0]["k1_ms"], "k2_ms": kernels[0]["k2_ms"],
        "kernel_gbps": size / k_total / 1e6,
        "vs_baseline": gpu_rt / host_rt,
        **stage_metrics(staged),
        "breakdown": {verb: breakdown(*traces[verb], staged[verb][-1])
                      for verb in VERBS},
        "host_compress_gbps": size / float(np.mean(host_c)) / 1e9,
        "host_decompress_gbps": size / float(np.mean(host_d)) / 1e9,
        "setup": {"cold_compress_s": cold_c, "cold_decompress_s": cold_d,
                  "checks_s": t_checks, "baseline_s": t_base,
                  # Unlinks of earlier runs' outputs, between runs.
                  "unlinks": len(out.unlink_s),
                  "unlink_s": sum(out.unlink_s),
                  # The drive loops' super-batch (the card's, by default)
                  # and the kernel layer's cut, one card's batch of it.
                  "loop_batch_packets": gpu.super_batch_packets,
                  "kernel_batch_packets": launch},
        "detail": {"compress_s": t_c, "decompress_s": t_d,
                   "compress_gbps_blocks": wc["blocks"],
                   "decompress_gbps_blocks": wd["blocks"],
                   # /proc/meminfo after each run, each block's mean (kB).
                   **{f"{verb}_{key}_blocks": w[key]
                      for verb, w in (("compress", wc), ("decompress", wd))
                      for key in ("dirty_kb", "writeback_kb")},
                   # Per-run rates: 25th, 50th and 75th percentiles.
                   "compress_gbps_run_quartiles": wc["runs"],
                   "decompress_gbps_run_quartiles": wd["runs"],
                   "host_compress_s": host_c, "host_decompress_s": host_d,
                   # Each unlink call's seconds, in order.
                   "unlink_s": out.unlink_s,
                   "kernels": kernels,
                   # Each verb's stage-timed runs, before and after the
                   # window (stages.summarize).
                   "stages": staged,
                   # Each stage metric's two readings, before and after.
                   "stage_metric_runs": readings,
                   "trace": {verb: {"wall_s": t[0], "device_busy_s": t[1],
                                    "device_ms": t[2]}
                             for verb, (t, _) in traces.items()}},
    })
    return result


def stage_readings(runs: dict) -> dict:
    """{verb: [stage-timed runs' ``stages.summarize`` dicts]} -> {each of
    STAGE_METRICS: its reading in each run, in order} (a stage a run
    lacks reads 0); the metric is their mean."""
    return {key: [float(r[what] if thread is None
                        else r["threads"][thread].get(what, [0.0])[0])
                  for r in runs[verb]]
            for key, (verb, thread, what) in STAGE_METRICS.items()}


def stage_metrics(runs: dict) -> dict:
    """Each of STAGE_METRICS: the mean of its ``stage_readings``."""
    return {key: float(np.mean(v))
            for key, v in stage_readings(runs).items()}


def spread(x: list[float]) -> float:
    """Readings' range over their mean (0 where the mean is 0)."""
    mean = float(np.mean(x))
    return (max(x) - min(x)) / mean if mean else 0.0


def breakdown(trace, launches: dict, run: dict) -> dict:
    """One verb's traced run (``device_trace``), the launches it made and
    its stage-timed run -> {"device_ops": the traced run's device
    operations, the longest first, at most DEVICE_OPS, each {"name",
    "ms", "count"}; "trace_kernels": ``trace_kernels``; "idle_gaps" and
    "idle_by_loop_stage": the stage run's (``stages.attribute``)}."""
    top = sorted(trace[2].items(), key=lambda kv: -kv[1][0])[:DEVICE_OPS]
    return {"device_ops": [{"name": k, "ms": v[0], "count": v[1]}
                           for k, v in top],
            "trace_kernels": trace_kernels(trace[2], launches),
            "idle_gaps": run["idle_gaps"],
            "idle_by_loop_stage": run["idle_by_loop_stage"]}


def kernel_records(b: dict) -> str:
    """A breakdown's ``trace_kernels`` as words: each kernel's records in
    the trace of its launches in the run."""
    return ", ".join(f"{k} {n['records']} records of {n['launches']} "
                     f"launches" + ("" if n["records"] >= n["launches"]
                                    else ": short, the busy under-reads")
                     for k, n in b["trace_kernels"].items()) \
        or "no codec kernel launched"


def report(card: str, r: dict) -> None:
    """One line per layer with the card, then the cell's JSON line."""
    det = r["detail"]
    c = det["compress_gbps_run_quartiles"]
    d = det["decompress_gbps_run_quartiles"]
    pin = ("archive sha256 == its pin (the JAX package's archive)"
           if r["checks"]["archive_pinned"] else
           "no archive pin at this size")
    print(f"[{card}] {r['cell']}: {r['bytes']} B, {r['packets']} packets in "
          f"{r['super_batches']} batches of "
          f"{r['setup']['kernel_batch_packets']} packets (the drive loops' "
          f"launch) in the checks and the kernel layer, ratio "
          f"{r['ratio']:.6f}, "
          f"order-0 entropy {r['order0_bits_per_byte']:.6f} bits a byte; "
          f"every packet == the golden codec's, "
          f"{r['checks']['golden_sampled']} == the executable "
          f"specification's, archive == host archive, {pin}, md5 round "
          f"trip: ok", flush=True)
    for b, k in enumerate(det["kernels"]):
        print(f"[{card}] {r['cell']} kernel layer, batch {b} "
              f"({k['packets']} packets, {k['bytes']} B): K1 "
              f"{k['k1_ms']:.4f} ms, K2 {k['k2_ms']:.4f} ms (CUDA events, "
              f"least of {len(k['k1_reps'])})", flush=True)
    print(f"[{card}] {r['cell']} kernel layer: {r['kernel_gbps']:.4f} GB/s "
          f"(bytes / (K1 + K2))", flush=True)
    w = r["window_s"]
    print(f"[{card}] {r['cell']} end to end, {r['runs']} warm runs "
          f"({w[0]:.3f} s compress, {w[1]:.3f} s decompress), all bytes "
          f"over all seconds: compress {r['compress_gbps']:.6f} GB/s "
          f"(spread over {BLOCKS} blocks {r['compress_gbps_spread']:.4f}; "
          f"per run {c[0]:.6f} / {c[1]:.6f} / {c[2]:.6f}), decompress "
          f"{r['decompress_gbps']:.6f} GB/s (spread "
          f"{r['decompress_gbps_spread']:.4f}; per run {d[0]:.6f} / "
          f"{d[1]:.6f} / {d[2]:.6f}); mean process/io s: compress "
          f"{r['compress_process_s']:.6f}/{r['compress_io_s']:.6f}, "
          f"decompress {r['decompress_process_s']:.6f}/"
          f"{r['decompress_io_s']:.6f}; first / last block: " + ", ".join(
              f"{verb} {det[verb + '_gbps_blocks'][0]:.6f} / "
              f"{det[verb + '_gbps_blocks'][-1]:.6f} GB/s (Dirty "
              f"{det[verb + '_dirty_kb_blocks'][0]:.0f} / "
              f"{det[verb + '_dirty_kb_blocks'][-1]:.0f} kB, Writeback "
              f"{det[verb + '_writeback_kb_blocks'][0]:.0f} / "
              f"{det[verb + '_writeback_kb_blocks'][-1]:.0f} kB)"
              for verb in ("compress", "decompress")), flush=True)
    t = det["trace"]
    for verb in VERBS:
        top = r["breakdown"][verb]["device_ops"]
        print(f"[{card}] {r['cell']} traced {verb}: wall "
              f"{t[verb]['wall_s']:.6f} s, device busy "
              f"{t[verb]['device_busy_s'] * 1e3:.3f} ms = share "
              f"{t[verb]['device_busy_s'] / t[verb]['wall_s']:.4f} "
              f"({kernel_records(r['breakdown'][verb])}); " + ", ".join(
                  f"{op['name']} {op['ms']:.3f} ms x{op['count']}"
                  for op in top), flush=True)
    for verb in VERBS:
        busy = t[verb]["device_busy_s"]
        for when, run in zip(("before", "after"), det["stages"][verb]):
            print(f"[{card}] {r['cell']} stages {verb}, {when} the window: "
                  f"{stages.line(run, stages.STAGES[verb])}, share "
                  f"{run['device_share']:.4f} (the traced run's busy "
                  f"{busy:.6f} s)", flush=True)
        b = r["breakdown"][verb]
        gaps = "; ".join(
            f"at {g['start_ms']:.3f} ms for {g['ms']:.3f} ms (" + ", ".join(
                f"{label} {g[label]}" for _, label in stages.THREADS) + ")"
            for g in b["idle_gaps"])
        idle = ", ".join(f"{st} {sec:.6f} s"
                         for st, sec in b["idle_by_loop_stage"].items())
        ops = ", ".join(f"{op['name']} {op['ms']:.3f} ms x{op['count']}"
                        for op in b["device_ops"])
        print(f"[{card}] {r['cell']} breakdown {verb}: device ops {ops} "
              f"({kernel_records(b)}); longest idle gaps of the card "
              f"(stage run after the window): {gaps}; idle s by the "
              f"loop's stage: {idle}", flush=True)
    print(f"[{card}] {r['cell']} stage metrics, before / after the window "
          f"(spread: their range over their mean): " + ", ".join(
              f"{key} {v[0]:.6f} / {v[-1]:.6f} ({spread(v):.4f})"
              for key, v in det["stage_metric_runs"].items()), flush=True)
    print(f"[{card}] {r['cell']} baseline HostCompressor(threads=0): compress "
          f"{r['host_compress_gbps']:.6f} GB/s, decompress "
          f"{r['host_decompress_gbps']:.6f} GB/s; vs_baseline (round trip) "
          f"{r['vs_baseline']:.4f}", flush=True)
    s = r["setup"]
    once = "paid by the first cell" if s["build_load_s"] is None else (
        f"CUDA context {s['cuda_init_s']:.3f} s, kernel build and load "
        f"{s['build_load_s']:.3f} s, host codec build and load "
        f"{s['host_build_load_s']:.3f} s")
    print(f"[{card}] {r['cell']} set-up: the loops' super-batch "
          f"{s['loop_batch_packets']} packets; work directory on "
          f"{s['work_fs']}, {s['work_free_bytes']} B free; corpus "
          f"{s['corpus_s']:.3f} s, "
          f"{once}, cold first compress {s['cold_compress_s']:.6f} s, "
          f"decompress {s['cold_decompress_s']:.6f} s, checks and kernel "
          f"times {s['checks_s']:.3f} s, baseline {s['baseline_s']:.3f} s, "
          f"{s['unlinks']} unlinks of earlier runs' outputs "
          f"{s['unlink_s']:.6f} s (no run writes over a file); "
          f"the cell {s['cell_s']:.3f} s, the command so far "
          f"{s['elapsed_s']:.3f} s", flush=True)
    print(json.dumps(r), flush=True)


def setup_card() -> tuple:
    """The card's name and power limit, cuda:0, and the seconds of the
    set-up paid once: the CUDA context, the kernels' build and load, the
    host codec's build and load."""
    from gpuar_tpu_torch import native
    from gpuar_tpu_torch.ops import _kernels
    from gpuar_tpu_torch.probes import card as card_of

    device = torch.device("cuda", 0)
    once = {"cuda_init_s": _timed(lambda: torch.zeros(1, device=device))[0],
            "build_load_s": _timed(lambda: _kernels.load(
                ["encode", "decode"]))[0],
            "host_build_load_s": _timed(native.load)[0]}
    return card_of(), device, once


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpuar_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--cell", choices=sorted(CELLS), default=None,
                   help="the cell to run (default: every cell)")
    p.add_argument("--mib", type=int, default=None,
                   help="cut the cell's corpus to this many MiB")
    p.add_argument("--seconds", type=float, default=WINDOW_S,
                   help="timed wall seconds of each verb, at least (and "
                        f"at least {RUNS} runs each)")
    p.add_argument("--workdir", type=Path, default=OUT,
                   help="the directory that holds the cells' files "
                        "(default: %(default)s)")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("gpuar_tpu_torch.bench: no CUDA device "
                         "(torch.cuda.is_available() is false); the "
                         "benchmark measures the card and has no CPU "
                         "fallback")
    cells = [args.cell] if args.cell else list(CELLS)
    size_of = {c: CELLS[c] if args.mib is None else args.mib << 20
               for c in cells}
    args.workdir.mkdir(parents=True, exist_ok=True)
    disk_room(args.workdir, DISK_FILES * max(size_of.values()))
    from gpuar_tpu_torch.parallel.runner import GPUCompressor
    from gpuar_tpu_torch.pipeline import HostCompressor

    card, device, once = setup_card()
    host = HostCompressor(threads=0)
    for cell in cells:
        size = size_of[cell]
        t_cell = time.perf_counter()
        room = disk_room(args.workdir, DISK_FILES * size)
        t_corpus, data = _timed(lambda: corpus(cell, size))
        pin = ARCHIVE_SHA256[cell] if size == CELLS[cell] else None
        with tempfile.TemporaryDirectory(dir=args.workdir) as work:
            r = bench_cell(cell, data, Path(work), GPUCompressor(), host,
                           device, seconds=args.seconds, want_sha256=pin)
        refuse_foreign()
        r["setup"].update(corpus_s=t_corpus, **once, **room,
                          cell_s=time.perf_counter() - t_cell,
                          elapsed_s=time.perf_counter() - t_start)
        r["device"] = {"backend": "cuda", "card": card,
                       "name": torch.cuda.get_device_name(0),
                       "count": torch.cuda.device_count()}
        r["layers"] = LAYERS
        report(card, r)
        once = dict.fromkeys(once)   # paid once, by the first cell
    return 0


if __name__ == "__main__":
    sys.exit(main())
