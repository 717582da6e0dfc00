"""The port's benchmark on the card (the counterpart of ``bench.py``).

    python -m gpuar_tpu_torch.bench [--cell NAME] [--mib N]

The command of ``BENCHMARK.json``.  Each cell is a corpus coded as a file
through the port's main path on one host (``CELLS``); with no ``--cell``
every cell runs in turn.  ``--mib N`` cuts the cell's corpus to N MiB.
For each cell, in this order:

  1. set-up: the corpus, the CUDA context, the kernels' ``nvcc`` build and
     load (``_kernels.load``), the host codec's g++ build and load
     (``native.load``), and the cold first run: the first
     ``GPUCompressor().compress`` and ``.decompress`` of the file in the
     process;
  2. correctness, before any number is printed: on each 64 MiB
     super-batch, K1's packets (their first ``lengths[i]`` bytes) and
     lengths equal the port's golden codec's (``native.encode_batch``) for
     every packet, ``GOLDEN_SAMPLE`` of them (the first, the last and a
     seeded draw) equal the executable specification's
     (``ops/golden.py``, which shares no code with the kernels or the
     native codec), and K2 decodes K1's packets back to the batch; the
     GPU archive is byte-equal to ``HostCompressor``'s and, at a cell's
     full size, its sha256 equals ``ARCHIVE_SHA256`` (the JAX package's
     archive of the corpus, held there by the tests); the md5 of the
     decompressed file equals the corpus's.  A failure exits non-zero and
     prints no metric;
  3. the kernel layer: K1 (``ops/encode.py encode_batch``) and K2
     (``ops/decode.py decode_blob``) on each super-batch already on the
     card, timed by CUDA events (a warm-up, then 5 timings; the least is
     the figure, every one is kept), and the corpus bytes over the sum of
     the least K1 and K2 times (``kernel_gbps``);
  4. end to end: warm runs of compress then decompress of the file on
     local disk, in turn, until each verb has at least ``RUNS`` runs and
     ``--seconds`` (``WINDOW_S``) of timed wall time.  Each verb's metric
     is all its bytes over all its seconds; its spread is the
     inter-quartile range of the same rate over ``BLOCKS`` consecutive
     blocks of the runs, over their median.  The per-run median and
     quartiles, and the means of ``CompressionInfo``'s ``process_time``
     and ``io_time``, are reported beside it;
  5. the baseline: the port's own host codec, ``HostCompressor(threads=0)``
     on every core, on the same file (``HOST_RUNS`` runs, all bytes over
     all seconds); ``vs_baseline`` is the GPU round trip's rate over the
     host's;
  6. one traced compress and decompress (torch.profiler): the card's busy
     share of the wall time and its time per kernel and copy.

Every line printed carries the card's name and power limit (nvidia-smi);
the last line is one JSON object of the cell: ``correct``, the metrics
of BENCHMARK.json under their names, ``setup``, ``device`` (backend
"cuda", card, device count), ``layers`` (which layer each number times)
and ``detail`` (per-batch and per-run times).  Without a CUDA device the
command fails and says so: there is no CPU fallback and no replay.  The
functions take the device they run on, so the tests drive them on the
CPU, where the kernels' plain versions run and no time is reported.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gpuar_tpu_torch.bench import OUT, corpora, md5
from gpuar_tpu_torch.config import UNCOMPRESSED_PACKET_SIZE as P
from gpuar_tpu_torch.pipeline import DEFAULT_SUPER_BATCH_PACKETS

RUNS = 7          # at least this many timed warm runs of each verb,
WINDOW_S = 10.0   # and at least this many timed seconds of each
BLOCKS = 5        # consecutive blocks of the runs, for the spread
HOST_RUNS = 3     # timed runs of the host baseline
KERNEL_REPS = 5
GOLDEN_SAMPLE = 256   # packets a super-batch held to ops/golden.py
BATCH_BYTES = DEFAULT_SUPER_BATCH_PACKETS * P

# cell -> its corpus's bytes at full size (``corpus``; why each cell:
# BENCHMARK.json).
CELLS = {"random_64m": 64 << 20, "enwik8_proxy_100m": 100_000_000}
# cell -> the sha256 of its archive at full size: the JAX package's
# HostCompressor archive of the corpus (tests/test_torch_bench.py computes
# it and holds it to these values).
ARCHIVE_SHA256 = {
    "random_64m":
        "ba6042223b988998dbf0db530cb7e3c0765843b2747fbc7c81b61ef284f3f3b6",
    "enwik8_proxy_100m":
        "8165e628bea1bbd251e9e2d524354bb899031b66e06e8229877802528c1e0b52",
}

LAYERS = {
    "compress_gbps": "end to end: file bytes of every warm run / their "
                     "wall s, GPUCompressor().compress (file read, upload, "
                     "K1, compaction, download, splice, write)",
    "decompress_gbps": "end to end: the same for "
                       "GPUCompressor().decompress",
    "compress_process_s": "drive loop: CompressionInfo.process_time of a "
                          "compress, mean of the warm runs (submit and "
                          "fetch on the loop's thread, the device work it "
                          "waits for)",
    "compress_io_s": "drive loop: CompressionInfo.io_time of a compress, "
                     "mean (file read on the reader thread, splice, write "
                     "on the writer thread; the threads overlap, so io "
                     "plus process may exceed the wall)",
    "decompress_process_s": "drive loop: process_time of a decompress, "
                            "mean (submit, fetch and splice on the loop's "
                            "thread)",
    "decompress_io_s": "drive loop: io_time of a decompress, mean (read "
                       "and blob build on the reader thread, write on the "
                       "writer thread; io plus process may exceed the "
                       "wall)",
    "k1_ms": "kernel: K1 on super-batch 0 already on the card, CUDA events, "
             "least of 5",
    "k2_ms": "kernel: K2 on super-batch 0's compacted packets on the card, "
             "CUDA events, least of 5",
    "kernel_gbps": "kernel: corpus bytes / sum over super-batches of the "
                   "least K1 + K2 ms",
    "vs_baseline": "end to end: GPU round trip rate / "
                   "HostCompressor(threads=0) round trip rate, same file, "
                   "each all bytes over all seconds",
    "compress_device_busy_share": "device: the card's busy time (kernels "
                                  "and copies, torch.profiler) / wall time "
                                  "of one traced compress",
    "decompress_device_busy_share": "device: the same for one traced "
                                    "decompress",
}


class Failure(SystemExit):
    """A correctness check failed: exit non-zero, print no metric."""

    def __init__(self, msg: str):
        super().__init__(f"gpuar_tpu_torch.bench: {msg}")


def corpus(cell: str, size: int) -> bytes:
    """The cell's corpus: random bytes (seed 0xBE7C) or the enwik8 proxy,
    cached at its pinned sizes."""
    if cell == "random_64m":
        return corpora.random_bytes(size)
    return corpora.cached("enwik", size)


def batches(data: bytes):
    """The corpus as GPUCompressor cuts it: 64 MiB super-batches of P-byte
    packets, zero-padded, the file's last packet ragged -> [(raw [n, P]
    uint8, sizes [n] int32, the batch's bytes)]."""
    raw = np.frombuffer(data, np.uint8)
    out = []
    for lo in range(0, raw.size, BATCH_BYTES):
        chunk = raw[lo: lo + BATCH_BYTES]
        n = -(-chunk.size // P)
        rows = np.zeros((n, P), np.uint8)
        rows.reshape(-1)[: chunk.size] = chunk
        sizes = np.full(n, P, np.int32)
        sizes[-1] = chunk.size - (n - 1) * P
        out.append((rows, sizes, chunk))
    return out


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


def kernel_layer(data: bytes, device: torch.device, host,
                 reps: int = KERNEL_REPS,
                 golden_sample: int = GOLDEN_SAMPLE) -> list[dict]:
    """K1 then K2 on each super-batch on ``device``: every packet held to
    the port's golden codec (``host.encode_batch``), ``golden_sample`` of
    them to the executable specification, K2's output to the batch; on a
    CUDA device also timed -> [{"packets", "bytes", "comp_bytes" (the
    packets' total length), "golden_sampled", and on CUDA "k1_ms",
    "k2_ms" (the least) and "k1_reps", "k2_reps"}]."""
    from gpuar_tpu_torch.ops import decode, encode
    from gpuar_tpu_torch.parallel.codec import COMPACT_ROW_WORDS, compact_rows

    row_bytes = COMPACT_ROW_WORDS * 4
    rows_out, picked = [], []
    for b, (rows, sizes, chunk) in enumerate(batches(data)):
        d = torch.from_numpy(rows).to(device)
        s = torch.from_numpy(sizes).to(device)
        pk, ln = encode.encode_batch(d, s)
        want, want_len = host.encode_batch(chunk)
        packets, lengths = pk.cpu().numpy(), ln.cpu().numpy()
        check_packets(b, packets, lengths, want, want_len)
        idx = sample(rows.shape[0], golden_sample, seed=b)
        picked += [(b, int(i), packets[i, : lengths[i]].tobytes(),
                    chunk[i * P: (i + 1) * P].tobytes()) for i in idx]
        blob, roff, _ = compact_rows(pk, ln, row_bytes)
        blob, offs = blob.reshape(-1), roff * row_bytes
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
    check_golden(picked)
    return rows_out


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return time.perf_counter() - t, out


def device_trace(fn):
    """One call of fn under torch.profiler -> (wall s, device busy s,
    {kernel or copy name: [device ms, count]}).  Busy is the union of the
    card's kernel and copy intervals; the profiler adds host overhead to
    the wall time, so the end-to-end metrics come from untraced runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def quartiles(x) -> list[float]:
    return [float(q) for q in np.percentile(np.asarray(x, np.float64),
                                            [25, 50, 75])]


def window(size: int, seconds: list[float], blocks: int = BLOCKS) -> dict:
    """One verb's timed runs of ``size`` bytes -> "gbps" (every run's bytes
    over every run's seconds), "blocks" (the same rate over each of
    ``blocks`` consecutive blocks of runs), "spread" (the blocks'
    inter-quartile range over their median) and "runs" (the per-run
    rates' quartiles)."""
    t = np.asarray(seconds, np.float64)
    rate = [p.size * size / p.sum() / 1e9
            for p in np.array_split(t, min(blocks, t.size))]
    q = quartiles(rate)
    return {"gbps": t.size * size / t.sum() / 1e9, "blocks": rate,
            "spread": (q[2] - q[0]) / q[1],
            "runs": quartiles(size / t / 1e9)}


def bench_cell(cell: str, data: bytes, work: Path, gpu, host,
               device: torch.device, runs: int = RUNS,
               seconds: float = WINDOW_S, host_runs: int = HOST_RUNS,
               want_sha256: str | None = None,
               golden_sample: int = GOLDEN_SAMPLE) -> dict:
    """One cell on ``data``: the checks, and on a CUDA device the times
    (module docstring, steps 1-6).  ``gpu`` is the GPUCompressor under
    test, ``host`` a HostCompressor; files go to ``work``;
    ``want_sha256`` is the archive's pin, if any.  Raises Failure on a
    failed check."""
    cuda = device.type == "cuda"
    size = len(data)
    src, gip, back = work / "in.bin", work / "gpu.gip", work / "back.bin"
    host_gip, host_back = work / "host.gip", work / "host_back.bin"
    src.write_bytes(data)
    want_md5 = md5(src)

    # The cold first run (set-up), then its checks.
    cold_c, _ = _timed(lambda: gpu.compress(src, gip))
    cold_d, _ = _timed(lambda: gpu.decompress(gip, back))
    kernels = kernel_layer(data, device, host,
                           golden_sample=golden_sample)
    host_c, host_d = [], []
    for _ in range(host_runs):
        host_c.append(_timed(lambda: host.compress(src, host_gip))[0])
        host_d.append(_timed(lambda: host.decompress(host_gip,
                                                     host_back))[0])
    if md5(host_back) != want_md5:
        raise Failure("the host codec does not round-trip the corpus")
    check_archive(src, gip, back, host_gip, want_md5, want_sha256)

    # Warm runs, compress then decompress in turn, until each verb has
    # ``runs`` runs and ``seconds`` of them.
    t_c, t_d, infos = [], [], []
    while len(t_c) < runs or min(sum(t_c), sum(t_d)) < seconds:
        tc, ci = _timed(lambda: gpu.compress(src, gip))
        td, di = _timed(lambda: gpu.decompress(gip, back))
        t_c.append(tc)
        t_d.append(td)
        infos.append((ci, di))
    if cuda:
        # One traced run of each verb, after the timed ones.
        traces = {verb: device_trace(run) for verb, run in (
            ("compress", lambda: gpu.compress(src, gip)),
            ("decompress", lambda: gpu.decompress(gip, back)))}
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
    wc, wd = window(size, t_c), window(size, t_d)
    host_rt = size / (np.mean(host_c) + np.mean(host_d)) / 1e9
    gpu_rt = size / (np.mean(t_c) + np.mean(t_d)) / 1e9
    k_total = sum(k["k1_ms"] + k["k2_ms"] for k in kernels)
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
        "compress_device_busy_share":
            traces["compress"][1] / traces["compress"][0],
        "decompress_device_busy_share":
            traces["decompress"][1] / traces["decompress"][0],
        "vs_baseline": gpu_rt / host_rt,
        "host_compress_gbps": size / float(np.mean(host_c)) / 1e9,
        "host_decompress_gbps": size / float(np.mean(host_d)) / 1e9,
        "setup": {"cold_compress_s": cold_c, "cold_decompress_s": cold_d},
        "detail": {"compress_s": t_c, "decompress_s": t_d,
                   "compress_gbps_blocks": wc["blocks"],
                   "decompress_gbps_blocks": wd["blocks"],
                   # Per-run rates: 25th, 50th and 75th percentiles.
                   "compress_gbps_run_quartiles": wc["runs"],
                   "decompress_gbps_run_quartiles": wd["runs"],
                   "host_compress_s": host_c, "host_decompress_s": host_d,
                   "kernels": kernels,
                   "trace": {verb: {"wall_s": t[0], "device_busy_s": t[1],
                                    "device_ms": t[2]}
                             for verb, t in traces.items()}},
    })
    return result


def report(card: str, r: dict) -> None:
    """One line per layer with the card, then the cell's JSON line."""
    c = r["detail"]["compress_gbps_run_quartiles"]
    d = r["detail"]["decompress_gbps_run_quartiles"]
    pin = ("archive sha256 == its pin (the JAX package's archive)"
           if r["checks"]["archive_pinned"] else
           "no archive pin at this size")
    print(f"[{card}] {r['cell']}: {r['bytes']} B, {r['packets']} packets in "
          f"{r['super_batches']} super-batches, ratio {r['ratio']:.6f}, "
          f"order-0 entropy {r['order0_bits_per_byte']:.6f} bits a byte; "
          f"every packet == the golden codec's, "
          f"{r['checks']['golden_sampled']} == the executable "
          f"specification's, archive == host archive, {pin}, md5 round "
          f"trip: ok", flush=True)
    for b, k in enumerate(r["detail"]["kernels"]):
        print(f"[{card}] {r['cell']} kernel layer, super-batch {b} "
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
          f"{r['decompress_io_s']:.6f}", flush=True)
    t = r["detail"]["trace"]
    for verb in ("compress", "decompress"):
        top = sorted(t[verb]["device_ms"].items(), key=lambda kv: -kv[1][0])
        print(f"[{card}] {r['cell']} traced {verb}: wall "
              f"{t[verb]['wall_s']:.6f} s, device busy "
              f"{t[verb]['device_busy_s'] * 1e3:.3f} ms = share "
              f"{r[verb + '_device_busy_share']:.4f}; " + ", ".join(
                  f"{k} {v[0]:.3f} ms x{v[1]}" for k, v in top[:6]),
              flush=True)
    print(f"[{card}] {r['cell']} baseline HostCompressor(threads=0): compress "
          f"{r['host_compress_gbps']:.6f} GB/s, decompress "
          f"{r['host_decompress_gbps']:.6f} GB/s; vs_baseline (round trip) "
          f"{r['vs_baseline']:.4f}", flush=True)
    s = r["setup"]
    once = "paid by the first cell" if s["build_load_s"] is None else (
        f"CUDA context {s['cuda_init_s']:.3f} s, kernel build and load "
        f"{s['build_load_s']:.3f} s, host codec build and load "
        f"{s['host_build_load_s']:.3f} s")
    print(f"[{card}] {r['cell']} set-up: corpus {s['corpus_s']:.3f} s, "
          f"{once}, cold first compress {s['cold_compress_s']:.6f} s, "
          f"decompress {s['cold_decompress_s']:.6f} s", flush=True)
    print(json.dumps(r), flush=True)


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
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gpuar_tpu_torch.bench: no CUDA device "
                         "(torch.cuda.is_available() is false); the "
                         "benchmark measures the card and has no CPU "
                         "fallback")
    from gpuar_tpu_torch import native
    from gpuar_tpu_torch.ops import _kernels
    from gpuar_tpu_torch.parallel.runner import GPUCompressor
    from gpuar_tpu_torch.pipeline import HostCompressor
    from gpuar_tpu_torch.probes import card as card_of

    card = card_of()
    device = torch.device("cuda", 0)
    t_init, _ = _timed(lambda: torch.zeros(1, device=device))
    t_build, _ = _timed(lambda: _kernels.load(["encode", "decode"]))
    t_native, _ = _timed(native.load)
    host = HostCompressor(threads=0)
    OUT.mkdir(parents=True, exist_ok=True)
    for cell in [args.cell] if args.cell else list(CELLS):
        size = CELLS[cell] if args.mib is None else args.mib << 20
        t_corpus, data = _timed(lambda: corpus(cell, size))
        pin = ARCHIVE_SHA256[cell] if size == CELLS[cell] else None
        with tempfile.TemporaryDirectory(dir=OUT) as work:
            r = bench_cell(cell, data, Path(work), GPUCompressor(), host,
                           device, seconds=args.seconds, want_sha256=pin)
        r["setup"].update(corpus_s=t_corpus, cuda_init_s=t_init,
                          build_load_s=t_build, host_build_load_s=t_native)
        r["device"] = {"backend": "cuda", "card": card,
                       "name": torch.cuda.get_device_name(0),
                       "count": torch.cuda.device_count()}
        r["layers"] = LAYERS
        report(card, r)
        t_init = t_build = t_native = None   # paid once, by the first cell
    return 0


if __name__ == "__main__":
    sys.exit(main())
