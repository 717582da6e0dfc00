#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path and its parallel layer on the GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and the CUDA
toolkit (nvcc).  It imports nothing of JAX.  Phases, each printing one line
with its result and its time; any failure is fatal (traceback, non-zero
exit, no result line):

  0. the card (nvidia-smi name and power limit, maximum SM clock), torch
     and CUDA versions;
  1. build the kernels from gpuar_tpu_torch/csrc for sm_90a, and print
     ptxas's registers, stack and spills of K1, K2 and K3, and of P1's
     v0_3pass_256, P2's 1x(1,512), P3's level 5 and P4's k_onehot; and,
     from cuobjdump's SASS, the shared-memory loads of P1's
     v8_raw_sum_256 (at least 256 a step of its chunk loop, so no step's
     table sum was hoisted or reused);
  2. K1 (encode) on the card against its plain PyTorch version and the
     golden codec, on boundary sizes and content classes at 8192 B;
  3. K2 (decode) against its plain version from a compacted blob, and K3
     (debug decode) on clean and noise-bodied packets: equal flags, and
     ContainerError for exactly the corrupt packets;
  4. the main path: a 160 MiB + 12,345 B mixed file through
     GPUCompressor().compress / .decompress (three 8192-packet
     super-batches, the last ragged), byte-identical to HostCompressor's
     archive, md5 round trip, the host archive decoded on the GPU and by
     the debug decoder; the kernels' launch counts over that run;
  5. the kernels at the main path's shapes: each kernel timed (CUDA
     events) on the file's three super-batches, and held against its
     plain version on the same card tensors at 0 tolerance on the full
     batch 0 and the ragged batch 2; on batch 0 the codec kernels' launch
     (threads and shared memory per block, one line: K1, K2 and K3 launch
     the same blocks), then K1, K2 and K3 timed on its
     first n packets for n in 1, 132, 1024, 4096, 8192 (the 1-packet time
     is a kernel's chain latency); then kernel against plain version at
     one small shape; then one warm sweep of the CLI (``c`` and ``d``) at
     --batch-packets 1024, 2048, 4096 and 8192 on a 64 MiB random file,
     printed on one line (``cli_sweep``);
  6. every local GPU: the phase 4 file through a GPUCompressor whose
     MeshCodec splits each super-batch over every card, or, on a one-card
     machine, over two DeviceCodecs of cuda:0 (each with its own streams):
     compress, decompress and debug decompress; the archive equals the
     host archive (and so phase 4's), md5 round trips, and every shard's
     codec launched K1 and K2 (K3 under debug); then the kernels at the
     shards' shapes, on the shard's card: the first shard of batch 0 and
     the last, ragged shard of batch 2 ([4096, 8192] and [2049, 8192] on
     one card, which are also the batches phase 7's ranks encode), each
     kernel held against its plain version at 0 tolerance as in phase 5;
  7. --multihost with a world of 2: two processes of the port's CLI
     (``c --multihost``, then ``d``, then ``d --debug``) joined through
     RANK / WORLD_SIZE / MASTER_ADDR=127.0.0.1 / a free MASTER_PORT, both
     on the local card(s); each rank prints its kernel launches, which
     must show K1 and K2 (K3 under debug) on both ranks, and its
     loop's coordination seconds and its reader's and writer's busy
     seconds (the multi-host loops run on three threads); the archive
     equals the host archive and both decodes round-trip.  The rank
     processes import no JAX;
  8. the probes P1-P4: ``python -m gpuar_tpu_torch.probes`` as a user runs
     it (every variant, configuration, level and primitive timed at the
     TPU probes' sizes, P1 and P2 at 512 and 8192 chains, P4's table
     probes at 1024 and 8192 tables) with its launch counts; the launch of
     P1-P4's chain kernels (threads and dynamic shared memory per block:
     one chain a thread, blocks of 64; P4's tables on PacketModel's
     81,920 B), and P3's levels 1-5 as shares of K1's time on the same
     bytes (the split of K1's chain; the median and range of 5
     interleaved rounds); on that run's card tensors every probe at every
     width against its plain version at 256 steps, and at its full size
     each probe's default and P1's v31/v32 (whose int16 counts wrap past
     32,767), at 0 tolerance; each probe's bound printed at the card's
     integer rate and at that of the SMs its launch fills;
  9. the measurement harnesses as a user runs them, each a subprocess
     whose non-zero exit fails the smoke: the benchmark's random_64m cell
     at full size and its enwik8_proxy_100m cell at 16 MiB, each with a
     3-second window a verb (every packet golden, sampled packets against
     the executable specification, archive == host archive and, at full
     size, its pinned sha256, md5 round trip, then the kernel layer and
     end-to-end numbers), ``bench.run --mib 16``, ``bench.soak --iters
     9`` with debug decode, and ``bench.scaling`` four times: the sleep
     control's compress (worlds 1 and 2 at the benchmark's measured
     compress rate); its decompress (``--mode d``, worlds 1, 2 and 4 at
     4 MiB a rank emulating 1 GiB in 16 segments, at the measured
     decompress rate); and the GPU compress and decompress at full width
     (``--backend gpu --mode c`` and ``--mode d``, worlds 1 and 2 at 128
     MiB a rank in ``_smoke/``: two 64 MiB super-batches or segments a
     rank, K1 and K2 on full launches, the reader and writer threads
     running), whose ranks share the one card, so their efficiencies
     are not a scaling figure.  Each decompress run checks its decoded
     file against the input.

    python3 chip_smoke.py --profile

also profiles one warm compress and decompress after phase 4: the
device's busy share and time per kernel (torch.profiler), the host
functions with the most self time and every ``np.copyto`` by caller
(cProfile); then one more of each with its stages timed by thread, no
profiler on (``stage_profile``: on the drive loop's thread the wait for
the upload buffer, submit, fetch, splice and its waits on the reader and
the writer; the reader's read and walk; the writer's write; the batch's
device work by CUDA events; the wall); and the splice of the three
super-batches into a fresh array, a reused buffer and in place
(``splice_choice``).

    python3 chip_smoke.py --parallel

runs only what spans cards, for a multi-card machine: phases 0 and 1,
the phase 4 file and its host archive, then phases 6 and 7 (no kernels
line, no phase 9).

The second-to-last line is a JSON object of the kernels: for K1-K3 ms,
plain_ms and bound_ms are batch 0's and launches phase 4's; for P1-P4 ms
is the default's (P1 v0_3pass_256 and P2 1x(1,512) at 512 chains, P3
level 5, P4 k_onehot at 1024 tables), plain_ms and bound_ms its full
size's, launches phase 8's.  bound_ms is the larger of the bytes over
3.35 TB/s and the operations over the card's rate (``bound``): each
kernel's own operations, as its source does them (the tallies below),
over the 32-bit integer rate, 16.75e12 a second; the bound by the plain
version's flat-table count at the float32 rate is printed beside it.
The last line is {"ok": true, "device": {...}}.  Times are printed beside
the card's name and power limit; the times of phases 6 and 7 show
processes or shards sharing the cards, not a scaling figure.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke"
MIB = 1 << 20
P = 8192
CARD = ""


def say(phase: str, msg: str, t0: float) -> None:
    print(f"[{phase}] {msg} ({time.perf_counter() - t0:.3f} s)", flush=True)


def timed(fn, reps: int = 1) -> float:
    """Milliseconds per call of fn on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(a.device, torch.int64))
               .abs().max()) if a.numel() else 0


# The H100 SXM's published peaks (NVIDIA's data sheet): device
# memory 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, which
# counts a fused multiply-add as two, so one 32-bit operation per lane per
# clock is 33.5e12 operations a second.  An SM has 64 INT32 lanes against
# 128 FP32 ones (NVIDIA's H100 architecture paper), so 32-bit integer
# operations issue at half that rate, 16.75e12 a second.  The kernels'
# operations are 32-bit integer ones, and every kernel's bound counts them
# at the integer rate; the float32 rate remains for the flat-table bound
# printed beside it.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = OPS_PER_S / 2

# Operations of one step of QuadModel (csrc/packet_model.cuh) as its
# source does them, one per arithmetic result, select, load or store.
# prefix(s): the 4 base-4 digits of s (4), the 2 shared nodes' addresses
# (4), their 2 16-byte loads, 2 bit tests a digit (8), 24 selects (the
# root's S by j0: 3; level 1's S1, S2, S3 of node j0: 9, then one of them
# by j1: 3; the level-2 node's by j2: 3; the leaf's by j3, for low and
# for high: 6) and 4 adds: 46.  bump(s): the root's 3 compares and 3 adds
# (6), level 1's 4 nodes each a subtract, 3 compares and 3 adds (28), and
# the 2 shared nodes each loaded, 3 compares and 4 adds, stored (18),
# their addresses and digits shared with prefix: 52.
TREE_PREFIX_OPS = 46
TREE_BUMP_OPS = 52
# The encoder's coder arithmetic a symbol (csrc/encode.cu, Coder::step,
# and P3's level 5, csrc/profile_encode.cu, Probe::step, which runs the
# same step): the reciprocal's load (1); narrow_by: span, cum, 3 products,
# 2 div_by of 6 (multiply-high, multiply, subtract, compare, select, add)
# and the bounds' adds and masks (22); renorm_s (19); m and the settled
# bits (3); settle's one-put path: the run length, its test, the pattern
# and the put into the 64-bit accumulator with its predicated store (26);
# the pending run's update (2): 73.
ENCODE_CODER_OPS = 73
# K1 a symbol: the symbol's shift and mask, prefix, bump, the coder: 173.
K1_SYMBOL_OPS = 2 + TREE_PREFIX_OPS + TREE_BUMP_OPS + ENCODE_CODER_OPS
# QuadModel::search (csrc/packet_model.cuh): a level's step over S1..S3
# is 3 products, 3 compares, rem's two selects and subtract, lo's two
# selects and add, and the child's count of 2 adds (14); the root's step
# (14); level 1's 3 picks of 3 selects and its step (23); the level-2
# node's index, address and load (5) and its step (14); the leaf's index,
# address and load (6); the leaf's 3 products and 3 compares (6), low's
# and high's 3 selects and an add each (8) and the symbol's index (4): 80.
SEARCH_OPS = 80
# bump's 2 shared nodes' addresses (4) and its 2 digits (2), which decode
# has no prefix to share with (TREE_BUMP_OPS leaves them to prefix).
BUMP_ADDRESS_OPS = 6
# The decoder's arithmetic a symbol (csrc/decode.cu, decode_kernel's
# loop): the refill test (1); span and its clamp (3); num (4); narrow_by's
# 2 products, 2 div_by of 6 and the bounds' adds and masks (19); cum's
# increment and the next reciprocal's index, test and load (4); renorm_s
# (19); shift_in's 64-bit shift, count, funnel shift and mask, and the
# code's select and xor (8); the byte's __byte_perm, the store's test and
# a quarter of the store with its address (4): 62.
DECODE_CODER_OPS = 62
# K3's flags a symbol: num's two range tests, their ors into the flag,
# the inversion's compare and or, the bit cursor (8).
DEBUG_OPS = 8
K2_SYMBOL_OPS = SEARCH_OPS + TREE_BUMP_OPS + BUMP_ADDRESS_OPS \
    + DECODE_CODER_OPS   # 200
K3_SYMBOL_OPS = K2_SYMBOL_OPS + DEBUG_OPS   # 208
# One refill of the decoder's bit reader, every 4 compressed bytes
# (BitReader::refill and load_next): the word's 3 shifts, 3 ors and mask
# (7), its 64-bit shift into the buffer (4), the count (1); the window's
# last byte (2), 4 clamped addresses and byte loads (12), the bytes inside
# (3), the mask (4), the cursor (1): 34.
REFILL_OPS = 34
# P2 a carry a step: c + (c >> 1) + t, a shift and two adds (3).
CARRY_OPS = 3
# P4 k_onehot's read (csrc/probe_layouts.cu, onehot_prefix): the 4
# digits (4), the 2 shared nodes' addresses (4) and loads (2), 13 masks
# (4 for j0, which level 1's reduces share, and 3 for each other digit;
# a compare each), 24 ANDs (the root's 3, level 1's 12, 3 a level below)
# and 20 adds (the reduces' 17, the levels' 3): 67.
ONEHOT_PREFIX_OPS = 67
# P4 k_onehot a step: the read, bump, and the symbol's and the sum's add
# and mask (4): 123.
P4_STEP_OPS = ONEHOT_PREFIX_OPS + TREE_BUMP_OPS + 4


def bound(nbytes: int, ops: int, rate: float = OPS_PER_S
          ) -> tuple[float, str]:
    """(least ms for the work, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over ``rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def model_ops(data: np.ndarray, sizes: np.ndarray, top: int):
    """(symbols coded, adds of the adaptive model's update) of packets
    data[i, :sizes[i]]: a symbol s adds one to every cumulative count
    above it, top - s of them."""
    keep = np.arange(data.shape[1])[None, :] < sizes[:, None]
    nsym = int(keep.sum())
    return nsym, top * nsym - int(data[keep].sum(dtype=np.int64))


def encode_err(pk, ln, plain_pk, plain_ln) -> int:
    """Largest difference between K1 and its plain version: in the lengths,
    and in each packet's first lengths[i] bytes (bytes past them are
    unconstrained)."""
    err = max_abs_err(ln, plain_ln)
    if err:
        return err
    keep = torch.arange(pk.shape[1], device=pk.device)[None, :] \
        < ln.to(torch.int64)[:, None]
    return max_abs_err(pk * keep, plain_pk.to(pk.device) * keep)


def md5(path: Path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(8 * MIB), b""):
            h.update(blk)
    return h.hexdigest()


def fixture_chunks(rng) -> list[tuple[str, bytes]]:
    """Boundary sizes and content classes, cut into 8192-byte packets."""
    from gpuar_tpu_torch.bench.corpora import adversarial_underflow_packet

    cases = [(f"random_{s}", rng.integers(0, 256, s, np.uint8).tobytes())
             for s in (0, 1, 2, 15, 16, 17, 255, 4096, 8191, 8192)]
    cases += [("all_zero", bytes(P)), ("all_ff", b"\xff" * P),
              ("text", (b"the quick brown fox jumps over the lazy dog. "
                        * 400)[:P + 300]),
              ("skewed", rng.choice([0, 1, 2, 255], size=9000,
                                    p=[0.7, 0.2, 0.05, 0.05])
               .astype(np.uint8).tobytes()),
              ("underflow_adversary", adversarial_underflow_packet()
               .tobytes())]
    return [(f"{name}[{o}]", blob[o: o + P]) for name, blob in cases
            for o in range(0, max(len(blob), 1), P)]


def to_batch(chunks):
    data = np.zeros((len(chunks), P), np.uint8)
    sizes = np.zeros(len(chunks), np.int32)
    for i, (_, c) in enumerate(chunks):
        data[i, : len(c)] = np.frombuffer(c, np.uint8)
        sizes[i] = len(c)
    return data, sizes


def blob_of(packets: np.ndarray, lengths: np.ndarray):
    """The reader-built compacted form of fixed-stride packets."""
    from gpuar_tpu_torch.pipeline import _PacketReader

    body = b"".join(packets[i, : lengths[i]].tobytes()
                    for i in range(len(lengths)))
    reader = _PacketReader(io.BytesIO(body))
    blob, roff, comp_len, raw = reader.read_batch_blob(len(lengths), 96, 4096)
    return blob, roff.astype(np.int64) * 96, comp_len, raw


def phase0() -> str:
    t0 = time.perf_counter()
    card = "nvidia-smi unavailable"
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        if smi.returncode == 0 and smi.stdout.strip():
            card = smi.stdout.strip().splitlines()[0]
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True)
        clock = clock.stdout.strip().splitlines()[0] \
            if clock.returncode == 0 and clock.stdout.strip() else "unknown"
    print(card, flush=True)
    if shutil.which("nvidia-smi"):
        print(f"maximum SM clock {clock}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    say("0 device", f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)", t0)
    return card


def phase1():
    from gpuar_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    for src in _kernels.sources():
        stale = _kernels.library_path(src)
        if stale.exists():
            stale.unlink()   # always build from the checkout's sources
    libs = _kernels.load()   # one nvcc per source, all at once
    seconds = time.perf_counter() - t0
    say("1 build", f"nvcc {' '.join(_kernels.NVCC_FLAGS)} -> "
        f"{', '.join(_kernels.library_path(p).name for p in _kernels.sources())}"
        f" ({len(libs)} libraries)", t0)
    for stem in ("encode", "decode"):
        for line in ptxas_usage(_kernels.BUILD_LOGS[stem]):
            print(f"[1 build] ptxas {stem}.cu {line}", flush=True)
    # P1's and P2's defaults, P3's whole step and P4's default table probe
    # (mangled template names).
    for stem, kernel in (("probe_model", "model_kernelILi0EE"),
                         ("probe_model", "carry_kernelILi1ELb0ELi1EE"),
                         ("profile_encode", "profile_kernelILi5EE"),
                         ("probe_layouts", "table_kernelILi2EE")):
        lines = [line for line in ptxas_usage(_kernels.BUILD_LOGS[stem])
                 if kernel in line]
        if not lines:
            raise AssertionError(f"no ptxas report of {kernel} in {stem}.cu")
        for line in lines:
            print(f"[1 build] ptxas {stem}.cu {line}", flush=True)
    # v8 sums all 256 rows of its column every step: its chunk loop (4
    # steps a word) must hold 4 x 256 shared-memory loads, the step past
    # the last chunk 256 more.
    lds = sass_opcodes("probe_model", "model_kernelILi8EE").get("LDS", 0)
    print(f"[1 build] SASS probe_model.cu v8_raw_sum_256: {lds} "
          f"shared-memory loads (LDS)", flush=True)
    if lds < 5 * 256:
        raise AssertionError(f"v8_raw_sum_256 has {lds} LDS, under 5 x 256: "
                             f"its table sum was hoisted out of the steps")
    return seconds


def sass_opcodes(stem: str, kernel: str) -> dict[str, int]:
    """The count of each SASS opcode (no modifiers) in the kernel whose
    mangled name holds ``kernel``, in the library built from
    ``csrc/<stem>.cu`` (cuobjdump -sass)."""
    from gpuar_tpu_torch.ops import _kernels

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
        / "bin" / "cuobjdump")
    lib = _kernels.library_path(next(p for p in _kernels.sources()
                                     if p.stem == stem))
    dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, int] = {}
    inside = False
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            inside = kernel in m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    if not counts:
        raise AssertionError(f"no SASS of {kernel} in {lib.name}")
    return counts


def ptxas_usage(log: str) -> list[str]:
    """Each kernel's registers, stack and spills from nvcc's -Xptxas -v
    report, one line a kernel (its mangled name first)."""
    lines, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = (f"{m.group(1)} B stack, {m.group(2)} B spill stores, "
                     f"{m.group(3)} B spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {frame}")
            name, frame = None, ""
    return lines


def phase2(dev, errs):
    from gpuar_tpu_torch import native
    from gpuar_tpu_torch.ops import encode, torch_codec

    t0 = time.perf_counter()
    chunks = fixture_chunks(np.random.default_rng(0xF1C5))
    data, sizes = to_batch(chunks)
    d, s = torch.from_numpy(data).to(dev), torch.from_numpy(sizes).to(dev)
    pk, ln = encode.encode_batch(d, s)
    torch.cuda.synchronize()
    stride = encode.out_geometry(P)[1] * 4
    plain_pk, plain_ln = torch_codec.encode_packets(d, s, stride)
    errs["encode"] = encode_err(pk, ln, plain_pk, plain_ln)
    if errs["encode"]:
        raise AssertionError(f"K1 differs from its plain version: "
                             f"{errs['encode']}")
    pk, ln = pk.cpu(), ln.cpu()
    for i, (name, c) in enumerate(chunks):
        if pk[i, : int(ln[i])].numpy().tobytes() != native.encode_packet(c):
            raise AssertionError(f"K1 lane {i} ({name}) differs from the "
                                 "golden codec")
    say("2 K1", f"{len(chunks)} packets (sizes 0..8192, zero/0xFF/text/"
        "skewed/underflow adversary) equal the plain version and the "
        "golden codec, max_abs_err 0", t0)
    return data, sizes, pk.numpy(), ln.numpy()


def phase3(dev, errs, data, sizes, packets, lengths):
    from gpuar_tpu_torch import container
    from gpuar_tpu_torch.ops import decode, torch_codec

    t0 = time.perf_counter()
    region = decode.out_geometry(P)[1] * 4
    blob, offs, _, raw = blob_of(packets, lengths)
    args = (torch.from_numpy(blob).to(dev), torch.from_numpy(offs).to(dev),
            torch.from_numpy(raw).to(dev))
    out = decode.decode_blob(*args)
    torch.cuda.synchronize()
    plain = torch_codec.decode_packets(
        torch_codec.gather_regions(args[0], args[1], region), args[2], P)
    errs["decode"] = max_abs_err(out, plain)
    if errs["decode"] or not np.array_equal(out.cpu().numpy(), data):
        raise AssertionError("K2 differs from its plain version or the data")
    say("3 K2", f"{len(raw)} packets decoded from a compacted blob equal "
        "the plain version and the data", t0)

    # K3: clean packets plus noise-bodied copies of the compressible ones.
    t0 = time.perf_counter()
    rng = np.random.default_rng(0xDEB6)
    ratio = lengths / np.maximum(sizes, 1)
    noisy = np.nonzero((sizes > 1024) & (ratio < 0.4))[0]
    corrupt = packets[noisy].copy()
    for j, i in enumerate(noisy):
        corrupt[j, 4: lengths[i]] = rng.integers(0, 256, lengths[i] - 4,
                                                 np.uint8)
    all_pk = np.concatenate([packets, corrupt])
    all_len = np.concatenate([lengths, lengths[noisy]])
    all_raw = np.concatenate([sizes, sizes[noisy]])
    blob, offs, comp_len, raw = blob_of(all_pk, all_len)
    args = (torch.from_numpy(blob).to(dev), torch.from_numpy(offs).to(dev),
            torch.from_numpy(raw).to(dev))
    out, flags = decode.decode_blob(*args, debug=True)
    torch.cuda.synchronize()
    rows = torch_codec.gather_regions(args[0], args[1], region)
    p_out, p_flags = torch_codec.decode_packets(rows, args[2], P, debug=True)
    errs["decode_debug"] = max(max_abs_err(out, p_out),
                               max_abs_err(flags, p_flags))
    if errs["decode_debug"]:
        raise AssertionError("K3 differs from its plain version")
    flags = flags.cpu().numpy()
    n = len(all_raw)
    overrun = flags[1] > comp_len.astype(np.int64) * 8 + 16
    flagged = np.nonzero((flags[0] != 0) | overrun)[0]
    want = np.arange(len(lengths), n)
    if not np.array_equal(flagged, want):
        raise AssertionError(f"K3 flags {flagged.tolist()}, corrupt are "
                             f"{want.tolist()}")
    try:
        decode.check_debug_flags(flags, comp_len, n)
        raise AssertionError("check_debug_flags did not raise")
    except container.ContainerError:
        pass
    decode.check_debug_flags(flags[:, : len(lengths)], comp_len, len(lengths))
    say("3 K3", f"flags equal the plain version; exactly the {len(noisy)} "
        "noise-bodied packets raise ContainerError", t0)


def make_file(path: Path) -> int:
    """160 MiB + 12,345 B: random (seed 0xBE7C), the enwik8 proxy, the
    high-byte UTF-8 proxy, a zero run, and a random tail."""
    from gpuar_tpu_torch.bench import corpora

    rng = np.random.default_rng(0xBE7C)
    with open(path, "wb") as f:
        f.write(rng.integers(0, 256, 56 * MIB, np.uint8).tobytes())
        f.write(corpora.generate(24 * MIB))
        f.write(corpora.generate_utf8(24 * MIB))
        f.write(bytes(56 * MIB))
        f.write(rng.integers(0, 256, 12345, np.uint8).tobytes())
    return path.stat().st_size


def setup4() -> Path:
    """The main path's file and its host archive (WORK / "host.gip")."""
    from gpuar_tpu_torch.pipeline import HostCompressor

    t0 = time.perf_counter()
    src = WORK / "in.bin"
    size = make_file(src)
    if size != 160 * MIB + 12345:
        raise AssertionError(f"file is {size} bytes")
    host = WORK / "host.gip"
    HostCompressor(threads=0).compress(src, host)
    say("4 setup", f"{size} B mixed file and its host archive "
        f"({host.stat().st_size} B)", t0)
    return src


def phase4(card, src):
    from gpuar_tpu_torch.ops import _kernels
    from gpuar_tpu_torch.parallel.runner import GPUCompressor

    t0 = time.perf_counter()
    size = src.stat().st_size
    host = WORK / "host.gip"
    gpu = GPUCompressor()
    _kernels.reset_counts()
    tc = time.perf_counter()
    gpu.compress(src, WORK / "gpu.gip")
    t_comp = time.perf_counter() - tc
    td = time.perf_counter()
    gpu.decompress(WORK / "gpu.gip", WORK / "back.bin")
    t_dec = time.perf_counter() - td
    gpu.decompress(host, WORK / "back_host.bin")
    GPUCompressor(debug=True).decompress(host, WORK / "back_debug.bin")
    launches = dict(_kernels.LAUNCHES)

    if (WORK / "gpu.gip").read_bytes() != host.read_bytes():
        raise AssertionError("GPU archive differs from the host archive")
    want = md5(src)
    for out in ("back.bin", "back_host.bin", "back_debug.bin"):
        if md5(WORK / out) != want:
            raise AssertionError(f"{out} does not round-trip (md5)")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    say("4 main path", f"archive == host archive (cmp), md5 round trip, "
        f"host archive decoded on the GPU and by the debug decoder; "
        f"launches {launches}", t0)
    runs = [("first run", t_comp, t_dec, None, None)]
    # A second run: the pinned buffers and the CUDA context are warm.
    for k in range(2):
        tc = time.perf_counter()
        ci = gpu.compress(src, WORK / "gpu2.gip")
        t_comp = time.perf_counter() - tc
        td = time.perf_counter()
        di = gpu.decompress(WORK / "gpu2.gip", WORK / "back2.bin")
        t_dec = time.perf_counter() - td
        runs.append((f"warm run {k + 1}", t_comp, t_dec, ci, di))
    if (WORK / "gpu2.gip").read_bytes() != host.read_bytes() \
            or md5(WORK / "back2.bin") != want:
        raise AssertionError("warm run differs")
    for name, t_comp, t_dec, ci, di in runs:
        split = "" if ci is None else (
            f"; pipeline split: compress process {ci.process_time:.6f} s "
            f"io {ci.io_time:.6f} s, decompress process "
            f"{di.process_time:.6f} s io {di.io_time:.6f} s")
        print(f"[{card}] main path {name}: compress {t_comp:.6f} s = "
              f"{size / t_comp / 1e9:.6f} GB/s, decompress {t_dec:.6f} s = "
              f"{size / t_dec / 1e9:.6f} GB/s ({size} B file, wall "
              f"time{split})", flush=True)
    return gpu, launches


def phase6(card, src, errs):
    """The phase 4 file through MeshCodec: every card, or two shards on
    one card; then the kernels against their plain versions at the
    shards' shapes."""
    from gpuar_tpu_torch.ops import _kernels
    from gpuar_tpu_torch.parallel.mesh import shard_bounds
    from gpuar_tpu_torch.parallel.runner import GPUCompressor

    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    if count > 1:
        devices, what = None, f"every card ({count} GPUs, one shard each)"
    else:
        devices = [torch.device("cuda", 0)] * 2
        what = "two DeviceCodecs on cuda:0 (one card)"
    gpu = GPUCompressor(devices=devices)
    debug = GPUCompressor(devices=devices, debug=True)
    _kernels.reset_counts()
    tc = time.perf_counter()
    gpu.compress(src, WORK / "mesh.gip")
    t_comp = time.perf_counter() - tc
    td = time.perf_counter()
    gpu.decompress(WORK / "mesh.gip", WORK / "mesh_back.bin")
    t_dec = time.perf_counter() - td
    debug.decompress(WORK / "host.gip", WORK / "mesh_debug.bin")
    launches = dict(_kernels.LAUNCHES)
    shards = [c.launches() for c in gpu.codec.codecs]
    debug_shards = [c.launches() for c in debug.codec.codecs]

    if (WORK / "mesh.gip").read_bytes() != (WORK / "host.gip").read_bytes():
        raise AssertionError("sharded archive differs from the host archive")
    want = md5(src)
    for out in ("mesh_back.bin", "mesh_debug.bin"):
        if md5(WORK / out) != want:
            raise AssertionError(f"{out} does not round-trip (md5)")
    if len(shards) < 2 or any(s["encode"] <= 0 or s["decode"] <= 0
                              for s in shards) \
            or any(s["decode_debug"] <= 0 for s in debug_shards):
        raise AssertionError(f"a shard did not launch its kernels: {shards} "
                             f"debug {debug_shards}")
    say("6 every GPU", f"{what}: archive == host archive (cmp), md5 round "
        f"trip, debug decode; launches {launches}, per shard {shards}, debug "
        f"per shard {debug_shards}", t0)
    size = src.stat().st_size
    tc = time.perf_counter()
    gpu.compress(src, WORK / "mesh2.gip")
    t_comp2 = time.perf_counter() - tc
    td = time.perf_counter()
    gpu.decompress(WORK / "mesh2.gip", WORK / "mesh_back2.bin")
    t_dec2 = time.perf_counter() - td
    for name, tc, td in (("first run", t_comp, t_dec),
                         ("warm run", t_comp2, t_dec2)):
        print(f"[{card}] {what}, {name}: compress {tc:.6f} s = "
              f"{size / tc / 1e9:.6f} GB/s, decompress {td:.6f} s = "
              f"{size / td / 1e9:.6f} GB/s ({size} B file, wall time; one "
              f"host feeds every shard: not a scaling figure)", flush=True)

    # The kernels at the shards' shapes, on the shard's own card.
    raw = np.fromfile(src, np.uint8)
    codecs = gpu.codec.codecs
    for b, last in ((0, False), (2, True)):
        tb = time.perf_counter()
        data, sizes = main_path_batch(raw, b)
        bounds = shard_bounds(data.shape[0], len(codecs))
        k = len(bounds) - 1 if last else 0   # shard k is on codecs[k]
        (a, z), dev = bounds[k], codecs[k].device
        with torch.cuda.device(dev):
            e, plain = against_plain(dev, data[a:z], sizes[a:z])
            torch.cuda.empty_cache()
        for key in e:
            errs[key] = max(errs.get(key, 0), e[key])
        print(f"[{card}] batch {b} shard [{a}, {z}) [{z - a}, {P}] on {dev}: "
              f"plain versions K1 {plain['encode']:.4f} ms, K2 "
              f"{plain['decode']:.4f} ms, K3 {plain['decode_debug']:.4f} ms; "
              f"K1 packets and lengths, K2 output, K3 output and flags equal "
              f"them (max_abs_err 0) and the data; debug flags clean",
              flush=True)
        say(f"6 batch {b} shard", "kernels against plain versions done", tb)


# One rank of phase 7: the port's CLI as a user runs it, then one JSON line
# with this process's kernel launches and its DistributedCompressor's
# coordination and lane seconds (recorded as the CLI builds it).
RANK_MAIN = """
import json, os, sys
from gpuar_tpu_torch import cli
from gpuar_tpu_torch.ops import _kernels
from gpuar_tpu_torch.parallel import distributed
made, init = [], distributed.DistributedCompressor.__init__
def recording(self, *args, **kw):
    init(self, *args, **kw)
    made.append(self)
distributed.DistributedCompressor.__init__ = recording
rc = cli.main(sys.argv[1:])
assert "jax" not in sys.modules, "the rank imported jax"
print(json.dumps({"rank": int(os.environ["RANK"]),
                  "launches": _kernels.LAUNCHES,
                  "coord_s": made[-1].coord.total,
                  "lanes_s": made[-1].lane_seconds}), flush=True)
sys.exit(rc)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(args: list[str], world: int = 2, timeout: float = 300):
    """Run the port's CLI, ``cli.main([*args, "--multihost", "--json"])``,
    as ranks 0..world-1 of one world (RANK_MAIN); -> [(the rank's JSON
    lines, seconds)].  A rank that fails or outlives the timeout fails the
    phase with its output."""
    env = {**os.environ, "WORLD_SIZE": str(world),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, *args, "--multihost", "--json",
         "--nointeractive"], cwd=ROOT, env={**env, "RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    results = []
    try:
        for r, p in enumerate(procs):
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                out, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                raise AssertionError(f"rank {r} of {args} hung "
                                     f"(>{timeout} s):\n{out[-3000:]}")
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of {args} exited "
                                     f"{p.returncode}:\n{out[-3000:]}")
            lines = [json.loads(x) for x in out.splitlines()
                     if x.startswith("{")]
            results.append((lines, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def phase7(card, src):
    """--multihost with a world of 2 through the port's CLI."""
    t0 = time.perf_counter()
    gip, back, dbg = WORK / "world.gip", WORK / "world.bin", \
        WORK / "world_debug.bin"
    runs = (("c", ["c", f"--in={src}", f"--out={gip}"], "encode"),
            ("d", ["d", f"--in={gip}", f"--out={back}"], "decode"),
            ("d --debug", ["d", f"--in={gip}", f"--out={dbg}", "--debug"],
             "decode_debug"))
    size = src.stat().st_size
    for name, args, kernel in runs:
        results = run_world(args)
        for rank, (lines, seconds) in enumerate(results):
            info, mine = lines[-2], lines[-1]
            if mine["rank"] != rank or mine["launches"][kernel] <= 0:
                raise AssertionError(f"{name}: rank {rank} did not launch "
                                     f"{kernel}: {mine}")
            lanes = mine["lanes_s"]
            print(f"[{card}] world 2 {name} rank {rank}: launches "
                  f"{mine['launches']}; process {info['process_time_s']} s, "
                  f"io {info['io_time_s']} s (reader {lanes['reader']:.6f}"
                  f" s, writer {lanes['writer']:.6f} s), coord "
                  f"{mine['coord_s']:.6f} s, rank exited after "
                  f"{seconds:.3f} s wall ({size} B file; both ranks share "
                  f"the card(s), process start-up included: not a scaling "
                  f"figure)", flush=True)
        if name == "c" and gip.read_bytes() != \
                (WORK / "host.gip").read_bytes():
            raise AssertionError("world-2 archive differs from the host "
                                 "archive")
    want = md5(src)
    for out in (back, dbg):
        if md5(out) != want:
            raise AssertionError(f"{out.name} does not round-trip (md5)")
    say("7 multihost", "world 2 (c, d, d --debug): archive == host archive "
        "(cmp), md5 round trips, K1 and K2 (K3 under debug) launched on "
        "both ranks", t0)


def profile_main_path(card, gpu, src) -> None:
    """One more warm compress and decompress under torch.profiler (device
    side, ``bench.__main__.device_trace``) and cProfile (host side): the
    device's busy share of the wall time, device time per kernel or copy,
    and the host functions with the most self time.  Both profilers add
    overhead to the wall time."""
    import cProfile
    import pstats

    from gpuar_tpu_torch.bench.__main__ import device_trace

    size = src.stat().st_size
    runs = (("compress", lambda: gpu.compress(src, WORK / "prof.gip")),
            ("decompress", lambda: gpu.decompress(WORK / "prof.gip",
                                                  WORK / "prof.bin")))
    for name, run in runs:
        host = cProfile.Profile()

        def profiled():
            host.enable()
            run()
            host.disable()

        wall, busy, per_name = device_trace(profiled)
        device = ", ".join(f"{k} {v[0]:.3f} ms x{v[1]}" for k, v in
                           sorted(per_name.items(), key=lambda kv: -kv[1][0]))
        print(f"[{card}] profile {name}: wall {wall:.6f} s "
              f"({size / wall / 1e9:.6f} GB/s), device busy "
              f"{busy * 1e3:.3f} ms = share {busy / wall:.4f}; "
              f"device: {device}", flush=True)
        stats = pstats.Stats(host).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
        print(f"[{card}] profile {name} host self time: " + "; ".join(
            f"{Path(f).name}:{line}({fn}) {tt:.6f} s x{nc}"
            for (f, line, fn), (_, nc, tt, _, _) in top), flush=True)
        # Every np.copyto, by caller: on the file compress only the
        # sizes' small copy is left under _upload, not the raw batch's.
        copies = [f"{Path(cf).name}:{cl}({cfn}) {ctt:.6f} s x{cnc}"
                  for (f, line, fn), (_, _, _, _, callers) in stats.items()
                  if "copyto" in fn
                  for (cf, cl, cfn), (cnc, _, ctt, _) in callers.items()]
        print(f"[{card}] profile {name} np.copyto by caller: "
              + ("; ".join(copies) or "none"), flush=True)


class _StageClock:
    """Seconds by thread and stage of one run: host stages by the host
    clock around the call that does them, on the thread that made it (the
    drive loop's own, its reader's or its writer's), device stages by CUDA
    events recorded on the codec's stream before and after the call that
    enqueues them.  The drive loop's waits on its reader and writer lanes
    are stages of its thread.  Spans from several threads add up under a
    lock."""

    def __init__(self):
        self.host: dict[tuple[str, str], list] = {}   # (thread, stage)
        self.events: dict[str, list] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, stage: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            sec = time.perf_counter() - t
            key = (threading.current_thread().name, stage)
            with self._lock:
                acc = self.host.setdefault(key, [0.0, 0])
                acc[0] += sec
                acc[1] += 1

    def host_stage(self, owner, attr: str, stage: str):
        fn = getattr(owner, attr)

        def timed_call(*args, **kw):
            with self.span(stage):
                return fn(*args, **kw)
        return mock.patch.object(owner, attr, timed_call)

    def lane_waits(self):
        """The drive loop's waits on a lane (``_Lane.wait``, also inside
        ``start``) as the stage "wait on <lane>"."""
        from gpuar_tpu_torch import pipeline

        wait, clock = pipeline._Lane.wait, self

        def timed_wait(lane):
            with clock.span(f"wait on {lane.name}"):
                return wait(lane)
        return mock.patch.object(pipeline._Lane, "wait", timed_wait)

    def device_stage(self, owner, attr: str, stage: str):
        fn = getattr(owner, attr)

        def timed_call(codec, *args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record(codec._stream)
            out = fn(codec, *args, **kw)
            end.record(codec._stream)
            with self._lock:
                self.events.setdefault(stage, []).append((start, end))
            return out
        return mock.patch.object(owner, attr, timed_call)

    def timed_open(self):
        """``open`` for the pipeline module: its files' readinto and read
        count as the read stage, their write as the write stage, on the
        thread that calls them."""
        clock = self

        class TimedFile:
            def __init__(self, f):
                self._f = f

            def readinto(self, b):
                with clock.span("read"):
                    return self._f.readinto(b)

            def read(self, *args):
                with clock.span("read"):
                    return self._f.read(*args)

            def write(self, b):
                with clock.span("write"):
                    return self._f.write(b)

            def __getattr__(self, name):
                return getattr(self._f, name)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self._f.close()

        return lambda *args, **kw: TimedFile(open(*args, **kw))

    THREADS = (("MainThread", "main"), ("gpuar-reader", "reader"),
               ("gpuar-writer", "writer"))

    def line(self, wall: float, order: list[str]) -> str:
        """The wall; each thread's stages in ``order`` then its waits, its
        busy sum (and, on the main thread, the rest of the wall); the
        device stages."""
        torch.cuda.synchronize()
        parts = [f"wall {wall:.6f} s"]
        for thread, label in self.THREADS:
            mine = {st: v for (th, st), v in self.host.items()
                    if th == thread}
            stages = [st for st in order if st in mine] \
                + sorted(st for st in mine if st.startswith("wait on"))
            busy = sum(mine[st][0] for st in stages)
            rest = f", rest {wall - busy:.6f} s" if label == "main" else ""
            parts.append(f"{label}: " + ", ".join(
                f"{st} {mine[st][0]:.6f} s x{mine[st][1]}" for st in stages)
                + f" (sum {busy:.6f} s{rest})")
        for stage in order:
            if stage in self.events:
                ev = self.events[stage]
                sec = sum(a.elapsed_time(b) for a, b in ev) / 1e3
                parts.append(f"device: {stage} {sec:.6f} s x{len(ev)} "
                             f"(CUDA events)")
        return "; ".join(parts)


COMPRESS_STAGES = ["read", "buffer wait", "submit", "H2D + K1 + compaction",
                   "fetch", "splice", "write"]
DECOMPRESS_STAGES = ["read", "walk", "buffer wait", "submit",
                     "H2D + K2 + D2H", "fetch", "write"]


def stage_profile(card, gpu, src) -> None:
    """One more warm compress and decompress with each stage timed
    (``_StageClock``, no profiler), by thread: on the drive loop's thread
    the wait for the slot's upload buffer, the submit's host time, the
    fetch, the splice, and its waits on the reader and the writer; on the
    reader's the file's read (and the walk); on the writer's the write;
    and the batch's device work by CUDA events on the codec's stream (the
    upload, the kernel, the compaction or the download).  A thread's
    stages are disjoint; the threads' and the device's overlap one
    another, so their sum may pass the wall, and the main thread's rest is
    the wall not in one of its stages."""
    from gpuar_tpu_torch import native, pipeline
    from gpuar_tpu_torch.parallel.codec import DeviceCodec
    from gpuar_tpu_torch.parallel.mesh import MeshCodec

    runs = (("compress", COMPRESS_STAGES,
             [("host", type(gpu), "encode_submit", "submit"),
              ("device", DeviceCodec, "encode_body_async",
               "H2D + K1 + compaction"),
              ("host", DeviceCodec, "fetch_blob", "fetch"),
              ("host", native, "splice_at", "splice")],
             lambda: gpu.compress(src, WORK / "stage.gip")),
            ("decompress", DECOMPRESS_STAGES,
             [("host", native, "walk_packets", "walk"),
              ("host", type(gpu), "decode_submit_blob", "submit"),
              ("device", DeviceCodec, "decode_blob_async", "H2D + K2 + D2H"),
              ("host", MeshCodec, "decode_body_wait", "fetch")],
             lambda: gpu.decompress(WORK / "stage.gip", WORK / "stage.bin")))
    for name, order, hooks, run in runs:
        clock = _StageClock()
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                pipeline, "open", clock.timed_open(), create=True))
            stack.enter_context(clock.host_stage(MeshCodec, "_staging",
                                                 "buffer wait"))
            stack.enter_context(clock.lane_waits())
            for kind, owner, attr, stage in hooks:
                hook = clock.device_stage if kind == "device" \
                    else clock.host_stage
                stack.enter_context(hook(owner, attr, stage))
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        print(f"[{card}] stages {name}: {clock.line(wall, order)}",
              flush=True)
    if md5(WORK / "stage.bin") != md5(src):
        raise AssertionError("the stage-timed run does not round-trip")


def splice_choice(card, src) -> None:
    """The splice of the main path's three super-batches three ways, on
    the blob K1 and the compaction leave in the pinned download buffer:
    into a fresh array (the parent's), into a reused host buffer, and in
    place in the pinned buffer itself (the drive loop's); 5 interleaved
    rounds, the median and range of each."""
    from gpuar_tpu_torch import native
    from gpuar_tpu_torch.parallel.codec import DeviceCodec

    codec = DeviceCodec(torch.device("cuda", 0))
    raw = np.fromfile(src, np.uint8)
    times: dict[str, list[float]] = {"fresh": [], "reused": [],
                                     "in place": []}
    work = torch.empty(8192 * codec.stride, dtype=torch.uint8,
                       pin_memory=True).numpy()
    reused = np.zeros_like(work)
    for _ in range(5):
        per = dict.fromkeys(times, 0.0)
        for b in range(3):
            data, sizes = main_path_batch(raw, b)
            blob, offs, lens = codec.fetch_blob(
                codec.encode_body_async(data, sizes))
            want = native.splice_at(blob, offs, lens)
            view = work[: blob.size]
            view[:] = blob
            for way, call in (
                    ("fresh", lambda: native.splice_at(blob, offs, lens)),
                    ("reused", lambda: native.splice_at(
                        blob, offs, lens, out=reused)),
                    ("in place", lambda: native.splice_at(
                        view, offs, lens, out=view))):
                t = time.perf_counter()
                got = call()
                per[way] += time.perf_counter() - t
                if not np.array_equal(got, want):
                    raise AssertionError(f"splice {way} differs")
        for way, sec in per.items():
            times[way].append(sec)
    print(f"[{card}] splice of the 3 super-batches (5 rounds): " + "; ".join(
        f"{way} median {float(np.median(v)):.6f} s "
        f"[{min(v):.6f}, {max(v):.6f}]" for way, v in times.items()),
        flush=True)


CLI_BATCH_PACKETS = (1024, 2048, 4096, 8192)   # --batch-packets swept


def cli_sweep(card) -> None:
    """The port's CLI (``cli.main``, in this process) at each
    CLI_BATCH_PACKETS on a 64 MiB file of the random_64m cell's corpus
    (``corpora.random_bytes``): at each size one untimed ``c`` and ``d``,
    then one of each timed by the wall around the call; the archive
    equals the 8192 one and the round trip is exact.  One line: wall s
    and GB/s of each verb and its ``--json`` process and io seconds.
    Data for the launch size; nothing here changes the default."""
    from gpuar_tpu_torch import cli
    from gpuar_tpu_torch.bench import corpora

    t0 = time.perf_counter()
    src, gip, back = WORK / "sweep.bin", WORK / "sweep.gip", \
        WORK / "sweep_back.bin"
    src.write_bytes(corpora.random_bytes(64 * MIB))
    want, archive, rows = md5(src), None, []
    for n in CLI_BATCH_PACKETS:
        row = {"batch_packets": n}
        for timed_run in (False, True):
            for verb, i, o in (("c", src, gip), ("d", gip, back)):
                out = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = cli.main([verb, f"--in={i}", f"--out={o}",
                                   f"--batch-packets={n}", "--json",
                                   "--nointeractive"])
                sec = time.perf_counter() - t
                if rc != 0:
                    raise AssertionError(f"cli {verb} --batch-packets={n} "
                                         f"exited {rc}: {out.getvalue()}")
                if timed_run:
                    stats = json.loads(out.getvalue().strip().splitlines()[-1])
                    row[verb] = {"s": sec, "gbps": 64 * MIB / sec / 1e9,
                                 "process_s": stats["process_time_s"],
                                 "io_s": stats["io_time_s"]}
        archive = archive or gip.read_bytes()
        if gip.read_bytes() != archive or md5(back) != want:
            raise AssertionError(f"--batch-packets={n}: archive or round "
                                 f"trip differs")
        rows.append(row)
    print(f"[{card}] CLI sweep, 64 MiB random, warm, one run a verb and "
          f"size: " + json.dumps(rows), flush=True)
    say("4 CLI sweep", f"--batch-packets {CLI_BATCH_PACKETS}: equal "
        f"archives, md5 round trips", t0)


def main_path_batch(raw: np.ndarray, b: int):
    """Super-batch b of the main path as GPUCompressor cuts it: up to 8192
    packets of P bytes, zero-padded, the last packet of the file ragged."""
    chunk = raw[b * 64 * MIB: (b + 1) * 64 * MIB]
    n = -(-chunk.size // P)
    data = np.zeros((n, P), np.uint8)
    data.reshape(-1)[: chunk.size] = chunk
    sizes = np.full(n, P, np.int32)
    sizes[-1] = chunk.size - (n - 1) * P
    return data, sizes


def ms_of(fn):
    """Milliseconds of one call of fn, synchronized (the plain versions)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def against_plain(dev, data: np.ndarray, sizes: np.ndarray):
    """K1, K2 and K3 on one batch's card tensors, each held against its
    plain version on the same tensors at 0 tolerance: K1 packets' first
    lengths[i] bytes and lengths, K2 output, K3 output and flags (both
    outputs also against the data), and the debug flags must be clean.
    -> ({kernel: max_abs_err}, {kernel: plain version ms}); raises on any
    difference."""
    from gpuar_tpu_torch.ops import decode, encode, torch_codec

    stride = encode.out_geometry(P)[1] * 4
    d, s = torch.from_numpy(data).to(dev), torch.from_numpy(sizes).to(dev)
    pk, ln = encode.encode_batch(d, s)
    plain_enc, (p_pk, p_ln) = ms_of(
        lambda: torch_codec.encode_packets(d, s, stride))
    e_enc = encode_err(pk, ln, p_pk, p_ln)
    del p_pk, p_ln
    blob, offs, comp_len, rs = blob_of(pk.cpu().numpy(), ln.cpu().numpy())
    args = (torch.from_numpy(blob).to(dev), torch.from_numpy(offs).to(dev),
            torch.from_numpy(rs).to(dev))
    rows = torch_codec.gather_regions(args[0], args[1], stride)
    out = decode.decode_blob(*args)
    plain_dec, p_out = ms_of(
        lambda: torch_codec.decode_packets(rows, args[2], P))
    e_dec = max(max_abs_err(out, p_out), max_abs_err(out, d))
    out, flags = decode.decode_blob(*args, debug=True)
    plain_dbg, (p_out, p_flags) = ms_of(
        lambda: torch_codec.decode_packets(rows, args[2], P, debug=True))
    e_dbg = max(max_abs_err(out, p_out), max_abs_err(flags, p_flags),
                max_abs_err(out, d))
    decode.check_debug_flags(flags.cpu().numpy(), comp_len, len(rs))
    if e_enc or e_dec or e_dbg:
        raise AssertionError(
            f"{list(data.shape)}: a kernel differs from its plain version "
            f"(max_abs_err K1 {e_enc}, K2 {e_dec}, K3 {e_dbg})")
    return ({"encode": e_enc, "decode": e_dec, "decode_debug": e_dbg},
            {"encode": plain_enc, "decode": plain_dec,
             "decode_debug": plain_dbg})


SWEEP = (1, 132, 1024, 4096, 8192)   # packets of batch 0 in the sweep


def codec_shape() -> tuple[int, int]:
    """(threads per block, shared memory bytes per block) of the codec
    kernels' launch: K1, K2 and K3 all launch PacketModel's blocks, which
    gpuar_decode_shape reports."""
    from gpuar_tpu_torch.ops import _kernels

    return _kernels.launch_shape("gpuar_decode_shape")


def sweep(card, d, s, args) -> None:
    """K1, K2 and K3 on the first n packets of batch 0 (SWEEP): a time that
    stays flat as n grows is one packet's chain (latency), one that grows
    with n is issue or bandwidth."""
    from gpuar_tpu_torch import probes
    from gpuar_tpu_torch.ops import decode, encode

    blob, offs, rs = args
    runs = {"K1 encode": lambda n: encode.encode_batch(d[:n], s[:n]),
            "K2 decode": lambda n: decode.decode_blob(blob, offs[:n], rs[:n]),
            "K3 debug decode": lambda n: decode.decode_blob(
                blob, offs[:n], rs[:n], debug=True)}
    for name, run in runs.items():
        ms = {n: probes.time_ms(lambda: run(n)) for n in SWEEP}
        times = ", ".join(f"n={n} {t:.4f} ms" for n, t in ms.items())
        print(f"[{card}] sweep {name}, first n packets of batch 0: {times}; "
              f"n=8192 / n=1 {ms[8192] / ms[1]:.3f}", flush=True)


def phase5(card, dev, src, errs):
    """Each kernel on the main path's three super-batches (CUDA events).
    On batch 0 ([8192, 8192], full) and batch 2 ([4098, 8192], ragged)
    each kernel is held against its plain version on the same card
    tensors at 0 tolerance (against_plain).  Then kernel against plain
    version at [32, 8192]."""
    from gpuar_tpu_torch import native
    from gpuar_tpu_torch.ops import decode, encode, torch_codec

    t0 = time.perf_counter()
    raw = np.fromfile(src, np.uint8)
    stride = encode.out_geometry(P)[1] * 4
    batch0 = {}
    for b, what in ((0, "56 MiB random + 8 MiB enwik proxy"),
                    (1, "16 MiB enwik + 24 MiB utf8 proxy + 24 MiB zeros"),
                    (2, "32 MiB zeros + 12,345 B random, ragged")):
        tb = time.perf_counter()
        data, sizes = main_path_batch(raw, b)
        d, s = torch.from_numpy(data).to(dev), torch.from_numpy(sizes).to(dev)
        ms_enc = timed(lambda: encode.encode_batch(d, s), reps=3)
        pk, ln = encode.encode_batch(d, s)
        blob, offs, comp_len, rs = blob_of(pk.cpu().numpy(),
                                           ln.cpu().numpy())
        args = (torch.from_numpy(blob).to(dev),
                torch.from_numpy(offs).to(dev), torch.from_numpy(rs).to(dev))
        ms_dec = timed(lambda: decode.decode_blob(*args), reps=3)
        ms_dbg = timed(lambda: decode.decode_blob(*args, debug=True), reps=3)
        mb = int(sizes.sum()) / 1e6
        print(f"[{card}] batch {b} {list(data.shape)} ({what}): K1 "
              f"{ms_enc:.4f} ms ({mb / ms_enc:.4f} GB/s), K2 {ms_dec:.4f} ms "
              f"({mb / ms_dec:.4f} GB/s), K3 {ms_dbg:.4f} ms "
              f"({mb / ms_dbg:.4f} GB/s)", flush=True)
        if b == 1:
            continue   # the same shape as batch 0

        if b == 0:
            threads, smem = codec_shape()
            print(f"[{card}] K1, K2 and K3 launch: {threads} threads per "
                  f"block, {smem} B of shared memory per block, one packet "
                  f"per thread, model a 4-ary prefix tree "
                  f"({-(-data.shape[0] // threads)} blocks for "
                  f"{data.shape[0]} packets)", flush=True)
            sweep(card, d, s, args)
            # The least time for batch 0's work (bound): K1 reads the raw
            # bytes and sizes and writes the packets and lengths; K2 reads
            # the blob, offsets and sizes and writes the bytes (K3 also
            # its flags).  The operations are each kernel's own a symbol
            # (K1_SYMBOL_OPS, K2_SYMBOL_OPS, K3_SYMBOL_OPS) and the
            # decoder's refills, one every 4 compressed bytes, over the
            # integer rate.  flat: the plain version's count, per symbol
            # the model's update (256 - s adds) and 16 operations of coder
            # arithmetic (8 more for the decoder's search), over the
            # float32 rate, the bound before the tree.
            n = data.shape[0]
            nsym, upd = model_ops(data, sizes, 256)
            enc_bytes = int(sizes.sum()) + 8 * n + int(ln.sum())
            dec_bytes = blob.size + offs.nbytes + rs.nbytes + n * P
            refills = REFILL_OPS * (int(ln.sum()) // 4)
            bounds = {"encode": bound(enc_bytes, K1_SYMBOL_OPS * nsym,
                                      INT32_OPS_PER_S),
                      "decode": bound(dec_bytes, K2_SYMBOL_OPS * nsym
                                      + refills, INT32_OPS_PER_S),
                      "decode_debug": bound(dec_bytes + 8 * n,
                                            K3_SYMBOL_OPS * nsym + refills,
                                            INT32_OPS_PER_S)}
            flats = {"encode": bound(enc_bytes, upd + 16 * nsym),
                     "decode": bound(dec_bytes, upd + 24 * nsym),
                     "decode_debug": bound(dec_bytes + 8 * n,
                                           upd + 24 * nsym)}
            print(f"[{card}] batch 0 bounds, each kernel's operations at "
                  f"the integer rate: " + ", ".join(
                      f"{k} {bounds[k][0]:.6f} ms ({bounds[k][1]}; "
                      f"flat-table count at the float32 rate "
                      f"{flats[k][0]:.6f} ms)" for k in bounds), flush=True)
        del pk, ln, args
        e, plain = against_plain(dev, data, sizes)
        for key in e:
            errs[key] = max(errs[key], e[key])
        if b == 0:
            batch0 = {key: (ms, plain[key], *bounds[key]) for key, ms in
                      (("encode", ms_enc), ("decode", ms_dec),
                       ("decode_debug", ms_dbg))}
        print(f"[{card}] batch {b} {list(data.shape)}: plain versions "
              f"K1 {plain['encode']:.4f} ms, K2 {plain['decode']:.4f} ms, "
              f"K3 {plain['decode_debug']:.4f} ms; K1 packets and lengths, "
              f"K2 output, K3 "
              f"output and flags equal them (max_abs_err 0) and the data; "
              f"debug flags clean", flush=True)
        say(f"5 batch {b}", "kernels against plain versions done", tb)
        torch.cuda.empty_cache()

    # Kernel against plain version at one small shape: 32 packets of text.
    small = raw[80 * MIB: 80 * MIB + 32 * P].reshape(32, P)
    d = torch.from_numpy(small).to(dev)
    s = torch.full((32,), P, dtype=torch.int32, device=dev)
    pk, ln = encode.encode_batch(d, s)
    lens = ln.cpu().numpy()
    blob, offs, _, rs = blob_of(pk.cpu().numpy(), lens)
    args = (torch.from_numpy(blob).to(dev), torch.from_numpy(offs).to(dev),
            torch.from_numpy(rs).to(dev))
    rows = torch_codec.gather_regions(args[0], args[1], stride)
    pairs = {
        "encode": (lambda: encode.encode_batch(d, s),
                   lambda: torch_codec.encode_packets(d, s, stride)),
        "decode": (lambda: decode.decode_blob(*args),
                   lambda: torch_codec.decode_packets(rows, args[2], P)),
        "decode_debug": (lambda: decode.decode_blob(*args, debug=True),
                         lambda: torch_codec.decode_packets(
                             rows, args[2], P, debug=True)),
    }
    for name, (kernel, plain) in pairs.items():
        ms = timed(kernel, reps=10)
        plain_ms, _ = ms_of(plain)
        print(f"[{card}] [32, 8192] text: {name} kernel {ms:.4f} ms, plain "
              f"version {plain_ms:.4f} ms", flush=True)
    if native.encode_packet(small[0].tobytes()) != \
            pk[0, : lens[0]].cpu().numpy().tobytes():
        raise AssertionError("K1 differs from the golden codec on text")
    say("5 times", "kernel timings done", t0)
    return batch0


# Phase 8, the probes: LAUNCHES key -> (name, source, the TPU call site).
PROBE_ROUTES = {
    "probe_model": ("P1 model-update probe",
                    "gpuar_tpu_torch/csrc/probe_model.cu",
                    "benchmarks/probe_model.py:187"),
    "probe_carry": ("P2 loop-carry probe",
                    "gpuar_tpu_torch/csrc/probe_model.cu",
                    "benchmarks/probe_model.py:236"),
    "profile_encode": ("P3 encoder phase ablation",
                       "gpuar_tpu_torch/csrc/profile_encode.cu",
                       "benchmarks/profile_encode.py:191"),
    "probe_layouts": ("P4 primitive probes",
                      "gpuar_tpu_torch/csrc/probe_layouts.cu",
                      "benchmarks/probe_layouts.py:43"),
}
PARITY_STEPS = 256   # steps of the every-variant parity check


def probe_shapes(card) -> None:
    """The launch of P1-P4's chain kernels, as their C entry points report
    it: one chain a thread in blocks of 64, and each variant's dynamic
    shared memory (the tree's nodes, a column of the table, or none); P2
    none, P4's table probes PacketModel's (the codec kernels')."""
    from gpuar_tpu_torch.ops import _kernels
    from gpuar_tpu_torch.probes import probe_model

    by_bytes: dict[int, list[str]] = {}
    threads = set()
    for i, name in enumerate(probe_model.VARIANTS):
        t, b = _kernels.launch_shape("gpuar_probe_model_shape", i)
        threads.add(t)
        by_bytes.setdefault(b, []).append(name.split("_")[0])
    t2, b2 = _kernels.launch_shape("gpuar_probe_carry_shape")
    t3, b3 = _kernels.launch_shape("gpuar_profile_encode_shape")
    t4, b4 = _kernels.launch_shape("gpuar_probe_table_shape")
    if threads != {64} or {t2, t3, t4} != {64}:
        raise AssertionError(f"P1 / P2 / P3 / P4 tables launch {threads} / "
                             f"{t2} / {t3} / {t4} threads a block, not one "
                             f"chain a thread in blocks of 64")
    if b4 != codec_shape()[1]:
        raise AssertionError(f"P4's tables take {b4} B a block, not "
                             f"PacketModel's {codec_shape()[1]}")
    shared = "; ".join(f"{b} B {', '.join(v)}"
                       for b, v in sorted(by_bytes.items(), reverse=True))
    print(f"[{card}] launch: P1 {threads.pop()} threads a block, one chain "
          f"a thread, "
          f"dynamic shared memory a block {shared}; P2 {t2} threads a "
          f"block, one chain a thread, {b2} B; P3 {t3} threads a "
          f"block, one packet a thread, {b3} B; P4's tables {t4} threads a "
          f"block, one table a thread, {b4} B", flush=True)


P3_ROUNDS = 5   # interleaved rounds of P3's levels and K1 (p3_split)


def p3_split(card, results) -> None:
    """P3's levels 1-5 as shares of K1's time on the same packets: where
    K1's chain goes (each level adds one phase of K1's step).  The entry
    point's reading, then P3_ROUNDS rounds that each time every level and
    K1 again: each share's median and range over the rounds."""
    from gpuar_tpu_torch import probes
    from gpuar_tpu_torch.ops import encode
    from gpuar_tpu_torch.probes import profile_encode

    ms = {r["name"]: r["ms"] for r in results if r["probe"] == "P3"}
    k1 = ms["K1"]
    levels = [ms[f"L{lv}"] for lv in range(1, 6)]
    steps = [levels[0]] + [b - a for a, b in zip(levels, levels[1:])]
    names = ("model", "+ arithmetic", "+ appends", "+ stores",
             "+ fill words")
    print(f"[{card}] P3 levels as shares of K1 ({k1:.4f} ms) on the same "
          f"packets: " + ", ".join(
              f"L{i + 1} {lv / k1:.2%}" for i, lv in enumerate(levels))
          + "; by phase: " + ", ".join(
              f"{n} {d / k1:+.2%}" for n, d in zip(names, steps)),
          flush=True)
    r = next(r for r in results if r["probe"] == "P3" and r["name"] == "L1")
    words, sizes = r["words"], r["sizes"]
    data = words.T.contiguous().view(torch.uint8)
    shares = [[] for _ in levels]
    for _ in range(P3_ROUNDS):
        got = [probes.time_ms(lambda lv=lv: profile_encode.profile(
            words, sizes, lv, profile_encode.STEPS)) for lv in range(1, 6)]
        k1 = probes.time_ms(lambda: encode.encode_batch(data, sizes))
        for i, t in enumerate(got):
            shares[i].append(t / k1)
    print(f"[{card}] P3 levels as shares of K1 over {P3_ROUNDS} rounds, "
          f"median (min-max): " + ", ".join(
              f"L{i + 1} {float(np.median(v)):.2%} "
              f"({min(v):.2%}-{max(v):.2%})" for i, v in enumerate(shares)),
          flush=True)


def phase8(card):
    """The probe entry point as a user runs it (``python -m
    gpuar_tpu_torch.probes``: P1 and P2 at 512 and 8192 chains, P3 levels
    1-5 and K1, P4 at the probes' sizes, its table probes at 1024 and 8192
    tables), with its launch counts.  Then, on that run's card tensors,
    every P1 variant, P2 configuration, P3 level and P4 probe at every
    width against its plain version at PARITY_STEPS steps, and at its
    full size each probe's default (the one the kernels line times) and
    P1's v31/v32 at 512 chains; all at 0 tolerance.
    -> {key: kernels line entry}."""
    from gpuar_tpu_torch import probes
    from gpuar_tpu_torch.probes import __main__ as entry
    from gpuar_tpu_torch.probes import (
        probe_layouts,
        probe_model,
        profile_encode,
    )

    t0 = time.perf_counter()
    probes.reset_counts()
    results = entry.main([])
    torch.cuda.synchronize()
    launches = dict(probes.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a probe kernel never launched: {launches}")
    say("8 probes", f"python -m gpuar_tpu_torch.probes: {len(results)} "
        f"timings; launches {launches}", t0)
    probe_shapes(card)
    p3_split(card, results)

    t0 = time.perf_counter()
    errs = dict.fromkeys(PROBE_ROUTES, 0)

    def hold(key, what, got, want):
        got, want = (got, want) if isinstance(got, tuple) else \
            ((got,), (want,))
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        errs[key] = max(errs[key], err)
        if err:
            raise AssertionError(f"{what}: the kernel differs from its "
                                 f"plain version (max_abs_err {err})")

    from gpuar_tpu_torch.bench.corpora import adversarial_underflow_packet

    steps = PARITY_STEPS
    adversary = torch.from_numpy(
        adversarial_underflow_packet(steps).view("<i4").copy())
    checked = 0
    for r in results:
        probe, name = r["probe"], r["name"]
        what = f"{probe} {name} [{r['width']}], {steps} steps"
        if probe == "P1":
            w = r["words"]
            hold("probe_model", what, probe_model.model(w, name, steps // 2, 2),
                 probe_model.model_plain(w, name, steps // 2, 2))
        elif probe == "P2":
            w = r["words"]
            hold("probe_carry", what, probe_model.carry(w, name, steps),
                 probe_model.carry_plain(w.shape[1], steps, name, w.device))
        elif probe == "P3" and name != "K1":
            # Packet 1 is the underflow adversary (whole fill words at
            # L5); packets 2 and 3 are short and empty.
            w = r["words"][: steps // 4].clone()
            w[:, 1] = adversary.to(w.device)
            s = torch.full_like(r["sizes"], steps)
            s[2], s[3] = steps // 3, 0
            level = int(name[1:])
            hold("profile_encode", what,
                 profile_encode.profile(w, s, level, steps),
                 profile_encode.profile_plain(w, s, level, steps))
        elif probe == "P4":
            seed = r["seed"]
            if name in probe_layouts.SCALAR:
                got = probe_layouts.scalar(seed, name, steps)
                want = probe_layouts.scalar_plain(seed, name, steps)
            else:
                got = probe_layouts.table(seed, name, r["width"], steps)
                want = probe_layouts.table_plain(name, r["width"], steps,
                                                 seed.device)
            hold("probe_layouts", what, got, want)
        else:
            continue
        checked += 1
    say("8 parity", f"{checked} variants, configurations, levels and probes "
        f"equal their plain versions at {steps} steps (max_abs_err 0)", t0)

    # Each probe's default at its full size: the entry point's output
    # against the plain version on the same inputs, timed, and its bound.
    def find(probe, name, width):
        return next(r for r in results if r["probe"] == probe
                    and r["name"] == name and r["width"] == width)

    rows = {}
    tile = probe_model.TILE
    r = find("P1", probe_model.DEFAULT_VARIANT, tile)
    plain_ms, want = ms_of(lambda: probe_model.model_plain(
        r["words"], r["name"], probe_model.STEPS, probe_model.REPEAT))
    hold("probe_model", f"P1 {r['name']} [{tile}] full", r["out"], want)

    def model_bound(r, flat=False, rate=INT32_OPS_PER_S):
        # Per step of the tree: prefix, row 256's compare and select,
        # bump, two adds to chk, the symbol's shift and mask; each input
        # word read once, chk written once.  flat: the flat table's count
        # (the update's 255 - s adds, two reads, the adds, the shift and
        # mask) at the float32 rate, the bound before the tree.
        syms = r["words"].view(torch.uint8)
        nsym = syms.numel()
        nbytes = r["words"].nbytes + 4 * r["width"]
        if flat:
            return bound(nbytes, probe_model.REPEAT * (
                255 * nsym - int(syms.sum(dtype=torch.int64)) + 6 * nsym))
        return bound(nbytes, probe_model.REPEAT * nsym
                     * (TREE_PREFIX_OPS + TREE_BUMP_OPS + 6), rate)

    rows["probe_model"] = (r, plain_ms, model_bound(r),
                           model_bound(r, flat=True))
    # A count of row 255 passes 32,767 after about 32,500 steps, so only
    # the full run (65,536 steps a chain) takes the int16 counts of v31
    # and v32 through the wrap (v30 never updates its counts); v32 is v0's
    # function in int16 counts, and so differs from it once they wrap.
    for name in ("v31_i16_3pass", "v32_i16_mixed"):
        ri = find("P1", name, tile)
        hold("probe_model", f"P1 {name} [{tile}] full", ri["out"],
             probe_model.model_plain(ri["words"], name, probe_model.STEPS,
                                     probe_model.REPEAT))
    if torch.equal(find("P1", "v32_i16_mixed", tile)["out"], r["out"]):
        raise AssertionError("v32_i16_mixed equals v0_3pass_256 at full "
                             "size: its int16 counts did not wrap")

    r = find("P2", probe_model.DEFAULT_CARRY, tile)
    iters = probe_model.STEPS * probe_model.REPEAT
    plain_ms, want = ms_of(lambda: probe_model.carry_plain(
        tile, iters, r["name"], r["out"].device))
    hold("probe_carry", f"P2 {r['name']} [{tile}] full", r["out"], want)

    def carry_bound(r, flat=False, rate=INT32_OPS_PER_S):
        # CARRY_OPS per carry per unrolled step over the integer rate
        # (flat: the same count over the float32 rate); the words are taken
        # and never read, so only the output moves.
        ncarry, packed, unroll = probe_model.CARRIES[r["name"]]
        return bound(4 * r["width"] * (ncarry if packed else 1),
                     CARRY_OPS * r["width"] * iters * ncarry * unroll,
                     OPS_PER_S if flat else rate)

    rows["probe_carry"] = (r, plain_ms, carry_bound(r),
                           carry_bound(r, flat=True))

    r = find("P3", f"L{profile_encode.DEFAULT_LEVEL}", profile_encode.B)
    plain_ms, want = ms_of(lambda: profile_encode.profile_plain(
        r["words"], r["sizes"], profile_encode.DEFAULT_LEVEL,
        profile_encode.STEPS))
    hold("profile_encode", f"P3 {r['name']} full", r["out"], want)
    # Every packet is full: per symbol the symbol's shift and mask, the
    # tree's prefix and bump and the coder's arithmetic; inputs read once,
    # out and len written once.  flat: the update's 255 - s adds and 16 of
    # coder arithmetic at the float32 rate, the bound before the tree.
    syms = r["words"].view(torch.uint8)
    nsym = syms.numel()
    ops = nsym * K1_SYMBOL_OPS   # level 5 runs K1's step
    nbytes = r["words"].nbytes + 2 * r["sizes"].nbytes + r["out"][0].nbytes
    flat = bound(nbytes, 255 * nsym - int(syms.sum(dtype=torch.int64))
                 + 16 * nsym)

    def encode_bound(r, flat=False, rate=INT32_OPS_PER_S):
        return bound(nbytes, ops, rate)

    rows["profile_encode"] = (r, plain_ms, encode_bound(r), flat)

    r = find("P4", probe_layouts.DEFAULT, probe_layouts.B)
    steps = probe_layouts.STEPS
    plain_ms, want = ms_of(lambda: probe_layouts.table_plain(
        r["name"], r["width"], steps, r["seed"].device))
    hold("probe_layouts", f"P4 {r['name']} full", r["out"], want)

    def onehot_bound(r, flat=False, rate=INT32_OPS_PER_S):
        # Table b counts symbol (7b + t) & 0xFF at step t: P4_STEP_OPS a
        # step over the integer rate; flat: the plain version's update of
        # 255 - s adds, one read, an add and a mask over the float32 rate.
        # Only the sums are written.
        n = r["width"]
        if not flat:
            return bound(4 * n, P4_STEP_OPS * n * steps, rate)
        # The adds of a table depend only on its offset 7b & 0xFF.
        t = torch.arange(steps)
        adds = torch.stack([(255 - ((o + t) & 0xFF)).sum()
                            for o in range(256)])
        return bound(4 * n, int(adds[(torch.arange(n) * 7) & 0xFF].sum())
                     + 3 * n * steps)

    rows["probe_layouts"] = (r, plain_ms, onehot_bound(r),
                             onehot_bound(r, flat=True))

    bound_of = {"probe_model": model_bound, "probe_carry": carry_bound,
                "profile_encode": encode_bound, "probe_layouts": onehot_bound}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launch_bound(key, r) -> str:
        # The integer rate of the SMs the launch fills: one chain, packet
        # or table a thread in blocks of 64, the blocks spread one an SM
        # before any SM takes a second.
        used = min(sms, -(-r["width"] // 64))
        b, by = bound_of[key](r, rate=INT32_OPS_PER_S * used / sms)
        return f"bound at the {used} of {sms} SMs it fills {b:.6f} ms ({by})"

    for key, (r, plain_ms, (bound_ms, by), flat) in rows.items():
        print(f"[{card}] {PROBE_ROUTES[key][0]} {r['name']} "
              f"[{r['width']}] full size: kernel {r['ms']:.4f} ms, plain "
              f"version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({by}, "
              f"integer rate of the card; flat-table count at the float32 "
              f"rate {flat[0]:.6f} ms), {launch_bound(key, r)}; equal at 0",
              flush=True)
    # P1, P2 and P4 k_onehot at K1's width too (the kernels line keeps the
    # probes' own widths).
    wide = (("probe_model", find("P1", probe_model.DEFAULT_VARIANT,
                                 probe_model.TILES[-1])),
            ("probe_carry", find("P2", probe_model.DEFAULT_CARRY,
                                 probe_model.TILES[-1])),
            ("probe_layouts", find("P4", probe_layouts.DEFAULT,
                                   probe_layouts.TABLES[-1])))
    for key, r in wide:
        fn = bound_of[key]
        (b, by), flat = fn(r), fn(r, flat=True)
        print(f"[{card}] {PROBE_ROUTES[key][0]} {r['name']} [{r['width']}]: "
              f"kernel {r['ms']:.4f} ms, bound {b:.6f} ms ({by}, integer "
              f"rate of the card; flat-table count at the float32 rate "
              f"{flat[0]:.6f} ms), {launch_bound(key, r)}", flush=True)
    say("8 full size", "each probe's default, v31 and v32 equal their "
        "plain versions", t0)
    return {key: {"name": PROBE_ROUTES[key][0], "route": "cuda",
                  "source": PROBE_ROUTES[key][1],
                  "replaces": PROBE_ROUTES[key][2],
                  "launches": launches[key], "max_abs_err": errs[key],
                  "ms": r["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": by, "library_ms": None}
            for key, (r, plain_ms, (bound_ms, by), _) in rows.items()}


# Phase 9: (name, module and arguments, the random_64m rate it takes as
# --chip-gbps or None) of each harness run.
HARNESSES = (
    ("bench random_64m", ["gpuar_tpu_torch.bench", "--cell", "random_64m",
                          "--seconds", "3"], None),
    ("bench enwik8_proxy_100m at 16 MiB",
     ["gpuar_tpu_torch.bench", "--cell", "enwik8_proxy_100m", "--mib", "16",
      "--seconds", "3"], None),
    ("run --mib 16", ["gpuar_tpu_torch.bench.run", "--mib", "16"], None),
    ("soak --iters 9", ["gpuar_tpu_torch.bench.soak", "--iters", "9"], None),
    ("scaling sleep", ["gpuar_tpu_torch.bench.scaling", "--backend",
                       "sleep", "--worlds", "1,2"], "compress_gbps"),
    ("scaling sleep d", ["gpuar_tpu_torch.bench.scaling", "--backend",
                         "sleep", "--mode", "d", "--worlds", "1,2,4",
                         "--per-host-mib", "4", "--emulate-gib", "1",
                         "--segments-per-host", "16"], "decompress_gbps"),
    ("scaling gpu c", ["gpuar_tpu_torch.bench.scaling", "--backend", "gpu",
                       "--mode", "c", "--worlds", "1,2", "--per-host-mib",
                       "128", "--tmpdir", str(WORK)], None),
    ("scaling gpu d", ["gpuar_tpu_torch.bench.scaling", "--backend", "gpu",
                       "--mode", "d", "--worlds", "1,2", "--per-host-mib",
                       "128", "--tmpdir", str(WORK)], None),
)


def phase9(card) -> None:
    """The harnesses (HARNESSES), each ``python -m`` in a subprocess as a
    user runs it; the sleep controls run at the random_64m cell's measured
    rate of the verb they time.  Prints each one's result lines (its JSON
    lines prefixed, so they are not taken for this script's own)."""
    rates = None
    for name, args, rate in HARNESSES:
        t0 = time.perf_counter()
        if rate is not None:
            args = [*args, "--chip-gbps", str(rates[rate])]
        r = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"{name} exited {r.returncode}:\n"
                                 f"{(r.stdout + r.stderr)[-4000:]}")
        lines = r.stdout.strip().splitlines()
        for line in lines:
            if line.strip():
                print(f"[9 {name}] {line}", flush=True)
        if name == "bench random_64m":
            rates = json.loads(lines[-1])
        say(f"9 {name}", f"exit 0 ({len(lines)} lines)", t0)


def main() -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one warm compress and decompress "
                             "(torch.profiler and cProfile)")
    parser.add_argument("--parallel", action="store_true",
                        help="run only phases 0, 1, 6 and 7 (and the file "
                             "they code): what spans cards")
    opts = parser.parse_args()
    t_all = time.perf_counter()
    CARD = phase0()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from gpuar_tpu_torch.ops import _kernels  # noqa: F401  (fails outside the repo)

    build_s = phase1()
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    try:
        errs: dict[str, int] = {}
        if not opts.parallel:
            batch = phase2(dev, errs)
            phase3(dev, errs, *batch)
        src = setup4()
        if not opts.parallel:
            gpu, launches = phase4(CARD, src)
            if opts.profile:
                profile_main_path(CARD, gpu, src)
                stage_profile(CARD, gpu, src)
                splice_choice(CARD, src)
            times = phase5(CARD, dev, src, errs)
            cli_sweep(CARD)
            del gpu
        phase6(CARD, src, errs)
        phase7(CARD, src)
        if not opts.parallel:
            probe_rows = phase8(CARD)
            phase9(CARD)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"[{CARD}] kernel build and load {build_s:.3f} s", flush=True)
    if opts.parallel:
        say("done", "phases 0, 1, 6 and 7 passed", t_all)
        return 0

    route = {"encode": ("K1 encode", "gpuar_tpu_torch/csrc/encode.cu",
                        "gpuar_tpu/ops/pallas_encode.py:167"),
             "decode": ("K2 decode", "gpuar_tpu_torch/csrc/decode.cu",
                        "gpuar_tpu/ops/pallas_decode.py:237"),
             "decode_debug": ("K3 debug decode",
                              "gpuar_tpu_torch/csrc/decode.cu",
                              "gpuar_tpu/ops/pallas_decode.py:237")}
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": errs[key], "ms": times[key][0],
                "plain_ms": times[key][1], "bound_ms": times[key][2],
                "bound_by": times[key][3], "library_ms": None}
               for key, (name, source, replaces) in route.items()]
    kernels += list(probe_rows.values())
    say("done", "all phases passed", t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
