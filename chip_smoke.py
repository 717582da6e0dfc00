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
     golden codec, on boundary sizes and content classes at 8192 B, and
     G1 (the body's gather) on K1's packets against its plain version and
     the golden codec's splice;
  3. K2 (decode) against its plain version from a compacted blob, and K3
     (debug decode) on clean and noise-bodied packets: equal flags, and
     ContainerError for exactly the corrupt packets, in the row blob and
     in the dense blob (the packets back to back, as the drive loops read
     them);
  4. the main path: a 160 MiB + 12,345 B mixed file through
     GPUCompressor().compress / .decompress, whose super-batch must be the
     card's (``runner.card_batch_packets``: the SMs and the codec kernels'
     occupancy; on the H100 4224 packets, five super-batches, the last
     ragged), byte-identical to HostCompressor's archive, md5 round trip,
     the host archive decoded on the GPU and by the debug decoder; the
     kernels' launch counts over that run; then one stage-timed warm run
     of each verb, whose lead-in (the call's start to the first device
     stage) and tail (the last fetch's start to the end of the last
     write) print on the line of the main path's batches;
  5. the kernels at the main path's shapes: each kernel timed (CUDA
     events) on each of the file's super-batches as phase 4 cut them, K2
     and K3 on the batch's dense blob, which ``read_batch_dense`` reads
     from phase 4's archive as the drive loop does (its block, two
     buffers in turn, the carry moved between them; some read must end
     inside a packet and some carry must be non-empty), and held on every
     batch to K2 and K3 on the row blob of K1's packets (both forms timed
     in turns) and to the data;
     each kernel (G1 too) held against its plain version on the same card
     tensors at 0 tolerance on the full batch 0 and the ragged last
     batch; on
     batch 0
     the codec kernels' launch (threads and shared memory per block, one
     line: K1, K2 and K3 launch the same blocks), then K1, K2 and K3 timed
     on its first n packets for n in 1, 132, 1024, 4096, 8192 and one and
     two waves of the card (16,896 and 33,792 on the H100; batch 0's
     packets repeated past its end) (the 1-packet time is a kernel's chain
     latency); then G1 timed on K1's packets of batch 0 (random) and of
     the first batch of text, at the card's batch and at one wave, beside
     its plain version and the row compaction it replaced (``g1_times``);
     then kernel against plain version at one small shape; then
     one warm smoke of the CLI (``c`` and ``d``) at --batch-packets of
     each size ``--sweep`` sweeps on a 64 MiB random file, printed on one
     line (``cli_sweep``);
  6. every local GPU: the phase 4 file through a GPUCompressor whose
     MeshCodec splits each super-batch over every card, or, on a one-card
     machine, over two DeviceCodecs of cuda:0 (each with its own streams):
     compress, decompress and debug decompress; the archive equals the
     host archive (and so phase 4's), md5 round trips, and every shard's
     codec launched K1, G1 and K2 (K3 under debug); then the kernels at the
     shards' shapes, on the shard's card: the first shard of batch 0 and
     the last, ragged shard of the last batch, each kernel held against
     its plain version at 0 tolerance as in phase 5;
  7. --multihost with a world of 2: two processes of the port's CLI
     (``c --multihost``, then ``d``, then ``d --debug``) joined through
     RANK / WORLD_SIZE / MASTER_ADDR=127.0.0.1 / a free MASTER_PORT, both
     on the local card(s); each rank prints its super-batch, which must
     be rank 0's, and its kernel launches, which
     must show K1 and G1 (compress) and K2 (K3 under debug) on both
     ranks, and its
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
     at full size, its enwik8_proxy_100m cell at 16 MiB and its random_1g
     cell at 256 MiB (eight super-batches of the card's size on the
     H100, so the drive loops overlap across batches), each with a
     3-second window a verb (every packet golden, sampled packets against
     the executable specification, archive == host archive and, at full
     size, its pinned sha256, md5 round trip, then the kernel layer at
     the loops' launch, the stage-timed runs, the end-to-end numbers and
     each verb's breakdown), ``bench.run --mib 16``, ``bench.soak --iters
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
profiler on (``stage_profile``, the lines of
``gpuar_tpu_torch/bench/stages.py``: on the drive loop's thread the
files' open and close, the wait for the upload buffer, submit, fetch
and its waits on the reader and the writer (and the splice, which the
GPU path no longer calls); the reader's read, header walk and carry,
with the carry's bytes; the writer's write; the batch's device work by
CUDA events, compress's body download (D2H) as its own stage; the card's busy and idle seconds and the lead-in; the
wall), and decompress's feed on one line (read, header walk and carry in
seconds, over the archive's bytes, the carry in bytes and bytes a GiB).

    python3 chip_smoke.py --parallel

runs only what spans cards, for a multi-card machine: phases 0 and 1,
the phase 4 file and its host archive, then phases 6 and 7 (no kernels
line, no phase 9).

    python3 chip_smoke.py --sweep

runs only phases 0 and 1 and the launch-size sweep (``launch_sweep``):
a card's batch of 1/16, 1/8, 1/4, 1/2, 1 and 2 waves of the codec
kernels' launch and the JAX package's 8192 packets, each through
GPUCompressor's compress and decompress on the benchmark cells' three
corpora in interleaved rounds (5, 5 and 3), each run writing new files,
the median and quartiles of each, a table of the medians, and the size
the rule of ``choose_waves`` picks (``runner.BATCH_WAVES`` holds the
H100's); no kernels line.  About four minutes on the H100.

    python3 chip_smoke.py --edges

runs only phases 0 and 1 and, on the three cells' corpora at full size,
rounds (7, 7 and 5) of GPUCompressor()'s compress and decompress, each
timed by the wall and then stage-timed: each verb's GB/s, lead-in and
tail, each round's and their median; no kernels line.  It runs on any
tree of the port since its stage clock: copied into an earlier tree's
root and run from there, it measures that tree (parent against change
in one call).

The second-to-last line is a JSON object of the kernels: for K1-K3 and
G1 ms, plain_ms and bound_ms are batch 0's (K2's and K3's on its dense
blob, G1's on K1's packets: bytes, each body byte read and written once)
and launches phase 4's; G1 replaces no TPU kernel (the JAX package's row
compaction in XLA and its host splice; "replaces" names them); for P1-P4
ms
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
import itertools
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

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


def gather_err(pk, ln):
    """G1 on K1's packets and lengths (card tensors) against its plain
    version on the same tensors -> (largest difference, G1's body): in the
    totals, and in the body's bytes."""
    from gpuar_tpu_torch.ops import encode

    body, total = encode.gather_body(pk, ln)
    plain, plain_total = encode.gather_body_plain(pk, ln)
    t = int(total)
    err = abs(t - int(plain_total))
    return (err or max_abs_err(body[:t], plain[:t])), body[:t]


def md5(path: Path, kind=hashlib.md5) -> str:
    h = kind()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(8 * MIB), b""):
            h.update(blk)
    return h.hexdigest()


def sha256(path: Path) -> str:
    return md5(path, hashlib.sha256)


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


def blob_of(packets: np.ndarray, lengths: np.ndarray, dense: bool = False):
    """A reader-built form of fixed-stride packets: the row form (96-byte
    rows, offsets = rows x 96) or, with ``dense``, the dense form the
    drive loops read (the packets back to back at their byte offsets)."""
    from gpuar_tpu_torch.pipeline import _PacketReader

    body = b"".join(packets[i, : lengths[i]].tobytes()
                    for i in range(len(lengths)))
    reader = _PacketReader(io.BytesIO(body))
    if dense:
        return reader.read_batch_dense(len(lengths))
    blob, roff, comp_len, raw = reader.read_batch_blob(len(lengths), 96, 4096)
    return blob, roff.astype(np.int64) * 96, comp_len, raw


class ArchiveReads:
    """An archive's body (the bytes past its header) for
    ``_PacketReader``, noting the body offset at which each read ended."""

    def __init__(self, path: Path):
        from gpuar_tpu_torch import container

        self._f = io.BytesIO(path.read_bytes()[container.HEADER_LENGTH:])
        self.ends: list[int] = []

    def readinto(self, b) -> int:
        k = self._f.readinto(b)
        if k:
            self.ends.append(self._f.tell())
        return k


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
    # G1 on K1's packets (4 B to the whole stride, so every offset past
    # the first few is unaligned): its plain version and the golden
    # codec's splice of the same rows.
    errs["gather"], body = gather_err(pk, ln)
    golden = native.splice(pk.cpu().numpy(), ln.cpu().numpy())
    if errs["gather"] or not np.array_equal(body.cpu().numpy(), golden):
        raise AssertionError(f"G1 differs from its plain version "
                             f"({errs['gather']}) or the golden splice")
    pk, ln = pk.cpu(), ln.cpu()
    for i, (name, c) in enumerate(chunks):
        if pk[i, : int(ln[i])].numpy().tobytes() != native.encode_packet(c):
            raise AssertionError(f"K1 lane {i} ({name}) differs from the "
                                 "golden codec")
    say("2 K1, G1", f"{len(chunks)} packets (sizes 0..8192, zero/0xFF/text/"
        "skewed/underflow adversary) equal the plain version and the "
        f"golden codec, max_abs_err 0; G1's {golden.size} B body equals its "
        "plain version and the golden splice", t0)
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
    # The same packets as the dense blob: a packet's lookahead now reads
    # its neighbour's bytes, and K3 must still flag exactly the corrupt.
    blob, offs, comp_len, raw = blob_of(all_pk, all_len, dense=True)
    args = (torch.from_numpy(blob).to(dev), torch.from_numpy(offs).to(dev),
            torch.from_numpy(raw).to(dev))
    out, flags = decode.decode_blob(*args, debug=True)
    torch.cuda.synchronize()
    rows = torch_codec.gather_regions(args[0], args[1], region)
    p_out, p_flags = torch_codec.decode_packets(rows, args[2], P, debug=True)
    e_dense = max(max_abs_err(out, p_out), max_abs_err(flags, p_flags))
    errs["decode_debug"] = max(errs["decode_debug"], e_dense)
    if e_dense:
        raise AssertionError("K3 on the dense blob differs from its plain "
                             "version")
    flags = flags.cpu().numpy()
    overrun = flags[1] > comp_len.astype(np.int64) * 8 + 16
    flagged = np.nonzero((flags[0] != 0) | overrun)[0]
    if not np.array_equal(flagged, want):
        raise AssertionError(f"K3 on the dense blob flags "
                             f"{flagged.tolist()}, corrupt are "
                             f"{want.tolist()}")
    say("3 K3", f"flags equal the plain version; exactly the {len(noisy)} "
        "noise-bodied packets raise ContainerError, in the row blob and in "
        "the dense blob", t0)


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
    from gpuar_tpu_torch.parallel import runner

    t0 = time.perf_counter()
    size = src.stat().st_size
    host = WORK / "host.gip"
    gpu = runner.GPUCompressor()
    # The batch from the cards: the SMs and the kernels' occupancy.
    sms, blocks, threads = runner.launch_geometry(torch.device("cuda", 0))
    card_n = torch.cuda.device_count() * runner.batch_packets(
        (sms, blocks, threads))
    if not gpu.batch_from_card or gpu.super_batch_packets != card_n:
        raise AssertionError(f"GPUCompressor()'s super-batch is "
                             f"{gpu.super_batch_packets} packets, not the "
                             f"card's {card_n}")
    print(f"[{card}] GPUCompressor() super-batch: {card_n} packets = "
          f"{torch.cuda.device_count()} card(s) x ceil({runner.BATCH_WAVES:g}"
          f" waves x {blocks} blocks an SM x {sms} SMs) x {threads} threads",
          flush=True)
    _kernels.reset_counts()
    tc = time.perf_counter()
    gpu.compress(src, WORK / "gpu.gip")
    t_comp = time.perf_counter() - tc
    td = time.perf_counter()
    gpu.decompress(WORK / "gpu.gip", WORK / "back.bin")
    t_dec = time.perf_counter() - td
    gpu.decompress(host, WORK / "back_host.bin")
    runner.GPUCompressor(debug=True).decompress(host, WORK / "back_debug.bin")
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
    total, n = -(-size // P), gpu.super_batch_packets
    print(f"[{card}] main path batches: {-(-total // n)} of {n} packets, "
          f"the last {total - (-(-total // n) - 1) * n}, both verbs; "
          f"{edge_line(gpu, src, want)}", flush=True)
    return gpu, launches


def edge_line(gpu, src: Path, want: str) -> str:
    """One stage-timed warm run of each verb of ``gpu`` on src (its round
    trip held to the md5 ``want``) -> their lead-in and tail, as text."""
    edges = {verb: edge_run(gpu, verb, a, WORK / f"edge.{verb}")
             for verb, a in (("compress", src),
                             ("decompress", WORK / "edge.compress"))}
    if md5(WORK / "edge.decompress") != want:
        raise AssertionError("the stage-timed run does not round-trip")
    for verb in edges:
        (WORK / f"edge.{verb}").unlink()
    return ", ".join(f"{verb} lead-in {e['lead_in_s'] * 1e3:.4f} ms, tail "
                     f"{e['tail_s'] * 1e3:.4f} ms"
                     for verb, e in edges.items()) \
        + " (a stage-timed warm run of each)"


def edge_run(gpu, verb: str, src: Path, dst: Path) -> dict:
    """One stage-timed ``gpu.compress`` or ``.decompress`` (the stage
    clock of ``gpuar_tpu_torch/bench/stages.py``) -> "wall_s", "lead_in_s"
    (the call's start to its first device stage: the first batch's read,
    which nothing overlaps) and "tail_s" (the start of the loop's last
    fetch to the end of the writer's last write: the last batch's fetch
    and write, which nothing overlaps)."""
    from gpuar_tpu_torch.bench import stages

    clock = stages.StageClock()
    devices = sorted({c.device.index for c in gpu.codec.codecs
                      if c.device.type == "cuda"})
    with clock.hooked(verb, type(gpu)):
        clock.start(devices)
        getattr(gpu, verb)(src, dst)
        clock.stop()
    run = clock.summary()
    fetch = max(a for thread, st, a, _ in clock.spans
                if thread == "MainThread" and st == "fetch")
    write = max(b for thread, st, _, b in clock.spans
                if thread == "gpuar-writer" and st == "write")
    return {"wall_s": run["wall_s"], "lead_in_s": run["lead_in_s"],
            "tail_s": write - fetch}


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
    if len(shards) < 2 or any(s["encode"] <= 0 or s["gather"] <= 0
                              or s["decode"] <= 0 for s in shards) \
            or any(s["decode_debug"] <= 0 for s in debug_shards):
        raise AssertionError(f"a shard did not launch its kernels: {shards} "
                             f"debug {debug_shards}")
    say("6 every GPU", f"{what}, super-batches of "
        f"{gpu.super_batch_packets} packets: archive == host archive (cmp), "
        f"md5 round trip, debug decode; launches {launches}, per shard "
        f"{shards}, debug per shard {debug_shards}", t0)
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

    # The kernels at the shards' shapes, on the shard's own card: batch 0's
    # first shard and the last batch's last, ragged one.
    raw = np.fromfile(src, np.uint8)
    codecs = gpu.codec.codecs
    n = gpu.super_batch_packets
    final = (-(-raw.size // P) - 1) // n
    for b, last in ((0, False), (final, True)):
        tb = time.perf_counter()
        data, sizes = main_path_batch(raw, b, n)
        bounds = shard_bounds(data.shape[0], len(codecs))
        k = len(bounds) - 1 if last else 0   # shard k is on codecs[k]
        (a, z), dev = bounds[k], codecs[k].device
        with torch.cuda.device(dev):
            e, plain = against_plain(dev, data[a:z], sizes[a:z])
            torch.cuda.empty_cache()
        for key in e:
            errs[key] = max(errs.get(key, 0), e[key])
        print(f"[{card}] batch {b} shard [{a}, {z}) [{z - a}, {P}] on {dev}: "
              f"plain versions K1 {plain['encode']:.4f} ms, G1 "
              f"{plain['gather']:.4f} ms, K2 {plain['decode']:.4f} ms, K3 "
              f"{plain['decode_debug']:.4f} ms; K1 packets and lengths, G1 "
              f"body, K2 output, K3 output and flags equal them "
              f"(max_abs_err 0) and the data; debug flags clean",
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
                  "batch_packets": made[-1].backend.super_batch_packets,
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
    runs = (("c", ["c", f"--in={src}", f"--out={gip}"], ("encode", "gather")),
            ("d", ["d", f"--in={gip}", f"--out={back}"], ("decode",)),
            ("d --debug", ["d", f"--in={gip}", f"--out={dbg}", "--debug"],
             ("decode_debug",)))
    size = src.stat().st_size
    for name, args, kernels in runs:
        results = run_world(args)
        for rank, (lines, seconds) in enumerate(results):
            info, mine = lines[-2], lines[-1]
            if mine["rank"] != rank or min(mine["launches"][k]
                                           for k in kernels) <= 0:
                raise AssertionError(f"{name}: rank {rank} did not launch "
                                     f"{kernels}: {mine}")
            if mine["batch_packets"] != results[0][0][-1]["batch_packets"]:
                raise AssertionError(f"{name}: rank {rank}'s super-batch "
                                     f"differs from rank 0's: {mine}")
            lanes = mine["lanes_s"]
            print(f"[{card}] world 2 {name} rank {rank}: super-batch "
                  f"{mine['batch_packets']} packets (rank 0's); launches "
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
        "(cmp), md5 round trips, K1, G1 and K2 (K3 under debug) launched on "
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


def stage_profile(card, gpu, src) -> None:
    """One more warm compress and decompress with each stage timed
    (``bench/stages.py``, no profiler), by thread: on the drive loop's
    thread the files' open and close, the wait for the slot's upload
    buffer, the submit's host time, the fetch, and its waits on the
    reader and the writer; on the reader's the file's read (and the
    walk); on the writer's the write; and the batch's device work by CUDA
    events on the codec's streams (the upload, K1 and G1 or K2, the
    download, and compress's body download, D2H).  A
    thread's stages are disjoint; the threads' and the device's overlap
    one another, so their sum may pass the wall, and the main thread's
    rest is the wall not in one of its stages."""
    from gpuar_tpu_torch.bench import stages

    runs = (("compress", src, WORK / "stage.gip"),
            ("decompress", WORK / "stage.gip", WORK / "stage.bin"))
    for verb, a, b in runs:
        run = stages.stage_run(gpu, verb, a, b)
        print(f"[{card}] stages {verb}: "
              f"{stages.line(run, stages.STAGES[verb])}", flush=True)
    # The dense feed of that decompress: the file's read, the header walk
    # (both over the archive's bytes once) and the carry.
    body = (WORK / "stage.gip").stat().st_size
    reader = run["threads"]["reader"]
    secs = {st: reader.get(st, [0.0, 0])[0] for st in ("read", "walk",
                                                       "carry")}
    carried = run["bytes"].get("carry", 0)
    print(f"[{card}] decompress feed: read {secs['read']:.6f} s and header "
          f"walk {secs['walk']:.6f} s over {body} B of archive; carry "
          f"{secs['carry']:.6f} s, {carried} B = {carried / body:.6f} of "
          f"the archive ({carried / (body / 2 ** 30):.0f} B a GiB)",
          flush=True)
    if md5(WORK / "stage.bin") != md5(src):
        raise AssertionError("the stage-timed run does not round-trip")


# A card's batch of each of these waves of the codec kernels' launch
# (``runner.batch_packets``): on the H100, 2 blocks an SM, f = 1/8, 1/4,
# 1/2, 1, 2 and 4 blocks an SM, 1088 to 33,792 packets.  16,896 is one
# wave; 33,792 is the reference's own rule, 8 blocks of 32 threads an SM.
SWEEP_WAVES = (1 / 16, 1 / 8, 1 / 4, 1 / 2, 1, 2)
# The JAX package's batch, swept beside them (pipeline.py).
JAX_BATCH = 8192


def card_sizes():
    """-> ((SMs, blocks per SM, threads per block) of cuda:0's launch,
    {packets: waves} of the swept sizes, JAX_BATCH's waves None)."""
    from gpuar_tpu_torch.parallel import runner

    geometry = runner.launch_geometry(torch.device("cuda", 0))
    sizes = {runner.batch_packets(geometry, w): w for w in SWEEP_WAVES}
    sizes.setdefault(JAX_BATCH, None)
    return geometry, dict(sorted(sizes.items()))


def cli_sweep(card) -> None:
    """A smoke of the launch size through the port's CLI (``cli.main``, in
    this process) at each of ``card_sizes`` on a 64 MiB file of the
    random_64m cell's corpus (``corpora.random_bytes``): at each size one
    untimed ``c`` and ``d``, then one of each timed by the wall around the
    call; the archive equals the 8192 one and the round trip is exact.
    One line: wall s and GB/s of each verb and its ``--json`` process and
    io seconds.  One run a size ranks nothing: ``--sweep`` does."""
    from gpuar_tpu_torch import cli
    from gpuar_tpu_torch.bench import corpora

    t0 = time.perf_counter()
    sizes = list(card_sizes()[1])
    src, gip, back = WORK / "sweep.bin", WORK / "sweep.gip", \
        WORK / "sweep_back.bin"
    src.write_bytes(corpora.random_bytes(64 * MIB))
    want, archives, rows = md5(src), {}, []
    for n in sizes:
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
        archives[n] = sha256(gip)
        if md5(back) != want:
            raise AssertionError(f"--batch-packets={n}: the round trip "
                                 f"differs")
        rows.append(row)
    if any(a != archives[JAX_BATCH] for a in archives.values()):
        raise AssertionError(f"an archive differs from the {JAX_BATCH} one")
    print(f"[{card}] CLI sweep (a smoke), 64 MiB random, warm, one run a "
          f"verb and size: " + json.dumps(rows), flush=True)
    say("5 CLI sweep", f"--batch-packets {sizes}: equal archives, md5 "
        f"round trips", t0)


# The shapes of ``--sweep``: each cell's corpus at full size, and the
# interleaved rounds it gets.
SWEEP_SHAPES = (("random_64m", 5), ("enwik8_proxy_100m", 5),
                ("random_1g", 3))
VERBS = ("compress", "decompress")


def launch_sweep(card) -> dict:
    """``--sweep``: the end-to-end rate of each of ``card_sizes`` on the
    three cells' corpora (SWEEP_SHAPES), a file on local disk through
    ``GPUCompressor(super_batch_packets=n)``'s ``compress`` then
    ``decompress``, each timed by the wall around the call; each run
    writes new files, unlinked after its checks.  A shape's sizes each
    get one untimed run, then rounds in which every size runs
    once, the order rotated by one size a round.  Every archive must
    equal the 8192 one (sha256) and every round trip the corpus (md5).
    One line a shape, size and verb: the median and quartiles of the
    rate, the medians of ``CompressionInfo``'s process and io seconds,
    and the median device time of a batch (CUDA events on the codec's
    stream around each batch's submit: upload, kernel, compaction or
    download).  Then the table of medians, the choice
    (``choose_waves``) and one JSON line of the medians and the
    choice."""
    from gpuar_tpu_torch.bench import stages
    from gpuar_tpu_torch.bench.__main__ import (
        CELLS, DISK_FILES, corpus, disk_room, quartiles)
    from gpuar_tpu_torch.parallel.codec import DeviceCodec
    from gpuar_tpu_torch.parallel.runner import GPUCompressor

    geometry, sizes = card_sizes()
    sms, blocks, threads = geometry
    print(f"[{card}] launch geometry: {sms} SMs, {blocks} blocks an SM "
          f"(the CUDA runtime's occupancy of K1, K2 and K3), {threads} "
          f"threads a block; sizes " + ", ".join(
              f"{n} ({'JAX' if w is None else f'f {w * blocks:g}'})"
              for n, w in sizes.items()), flush=True)
    gpus = {n: GPUCompressor(super_batch_packets=n) for n in sizes}
    submits = {"compress": "encode_body_async",
               "decompress": "decode_blob_async"}
    medians = {}
    for cell, rounds in SWEEP_SHAPES:
        t0 = time.perf_counter()
        size = CELLS[cell]
        disk_room(WORK, DISK_FILES * size)
        src = WORK / "launch.bin"
        src.write_bytes(corpus(cell, size))
        want, archive = md5(src), {}
        runs = {(v, n): [] for v in VERBS for n in sizes}
        count = itertools.count()

        def run(n, timed):
            # New files each run, unlinked after its checks: no run pays
            # the truncation of an earlier run's outputs.
            k = next(count)
            gip, back = WORK / f"launch_{k}.gip", WORK / f"launch_{k}.back"
            for verb, call in (
                    ("compress", lambda: gpus[n].compress(src, gip)),
                    ("decompress", lambda: gpus[n].decompress(gip, back))):
                clock = stages.StageClock()
                with clock.device_stage(DeviceCodec, submits[verb],
                                        "batch"):
                    t = time.perf_counter()
                    info = call()
                    sec = time.perf_counter() - t
                torch.cuda.synchronize()
                if timed:
                    runs[verb, n].append((
                        size / sec / 1e9, info.process_time, info.io_time,
                        clock.stage_ms("batch")))
            # JAX_BATCH runs first and sets the archive the others match.
            digest = sha256(gip)
            if archive.setdefault(JAX_BATCH, digest) != digest:
                raise AssertionError(f"{cell}: the archive at {n} packets "
                                     f"differs from the {JAX_BATCH} one")
            if md5(back) != want:
                raise AssertionError(f"{cell}: the round trip at {n} "
                                     f"packets differs (md5)")
            gip.unlink()
            back.unlink()

        order = [JAX_BATCH, *(n for n in sizes if n != JAX_BATCH)]
        for n in order:
            run(n, timed=False)
        for r in range(rounds):
            for n in order[r % len(order):] + order[: r % len(order)]:
                run(n, timed=True)
        for n, w in sizes.items():
            for verb in VERBS:
                got = runs[verb, n]
                q = quartiles([g[0] for g in got])
                per_batch = [ms for g in got for ms in g[3]]
                medians[cell, verb, n] = q[1]
                print(f"[{card}] sweep {cell} {verb} {n} packets "
                      f"({'JAX' if w is None else f'f {w * blocks:g}'}, "
                      f"{len(got[0][3])} batches): {len(got)} runs, GB/s "
                      f"median {q[1]:.6f} [{q[0]:.6f}, {q[2]:.6f}]; "
                      f"process {float(np.median([g[1] for g in got])):.6f}"
                      f" s, io {float(np.median([g[2] for g in got])):.6f}"
                      f" s; device {float(np.median(per_batch)):.4f} ms a "
                      f"batch (CUDA events)", flush=True)
        say(f"sweep {cell}", f"{len(sizes)} sizes, {rounds} rounds: every "
            f"archive == the {JAX_BATCH} one, md5 round trips", t0)
        src.unlink()
    keys = [(c, v) for c, _ in SWEEP_SHAPES for v in VERBS]
    print(f"[{card}] sweep table, median GB/s (" + ", ".join(
        f"{c} {v[0]}" for c, v in keys) + f"; geometric mean over "
        f"{JAX_BATCH}):", flush=True)
    for n in sizes:
        row = [medians[c, v, n] for c, v in keys]
        ratio = geomean([r / medians[c, v, JAX_BATCH]
                         for r, (c, v) in zip(row, keys)])
        print(f"[{card}]   {n:>6} packets: " + " ".join(
            f"{r:.6f}" for r in row) + f"  x{ratio:.4f}", flush=True)
    choice = choose_waves(medians, sizes, geometry)
    print(f"[{card}] launch choice: {json.dumps(choice)}", flush=True)
    print(json.dumps({"sweep": {f"{c} {v} {n}": m for (c, v, n), m in
                                medians.items()}, "choice": choice}),
          flush=True)
    return choice


def geomean(x) -> float:
    return float(np.exp(np.mean(np.log(x))))


def choose_waves(medians: dict, sizes: dict, geometry) -> dict:
    """The launch size's rule: of the card's sizes, the one with the
    largest geometric mean over the shapes and verbs of its median over
    JAX_BATCH's (a tie to the larger size: fewer launches), among those
    that lose no shape's median to JAX_BATCH's by more than that cell's
    bound in BENCHMARK.json; if every size does, f = 1, one block on
    every SM."""
    from gpuar_tpu_torch.parallel.runner import batch_packets

    blocks = geometry[1]
    bounds = {w["name"]: w["metrics"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]}
    keys = [(c, v) for c, _ in SWEEP_SHAPES for v in VERBS]
    scores, eligible = {}, []
    for n, w in sizes.items():
        if w is None:
            continue
        ratios = [medians[c, v, n] / medians[c, v, JAX_BATCH]
                  for c, v in keys]
        scores[n] = geomean(ratios)
        if all(r >= 1 - bounds[c][f"{v}_gbps"]["bound"]
               for r, (c, v) in zip(ratios, keys)):
            eligible.append(n)
    if eligible:
        n = max(eligible, key=lambda m: (scores[m], m))
        waves = sizes[n]
    else:
        waves = 1 / blocks
        n = batch_packets(geometry, waves)
    return {"packets": n, "waves": waves, "f": waves * blocks,
            "geomean_vs_8192": scores, "eligible": eligible}


# The shapes of ``--edges``: each cell's corpus at full size, and its
# rounds (each a plain and a stage-timed run of both verbs).
EDGE_SHAPES = (("random_64m", 7), ("enwik8_proxy_100m", 7), ("random_1g", 5))


def edges(card) -> dict:
    """``--edges``: the file's edges, on the three cells' corpora at full
    size (EDGE_SHAPES) through GPUCompressor().  Each round runs
    ``compress`` then ``decompress`` once timed by the wall around the
    call, then once stage-timed (``edge_run``: the lead-in and the tail);
    every run writes new files, the last round's unlinked between rounds,
    and every archive and round trip is checked (sha256 against the
    first, md5).  One line a cell and verb with each round's GB/s,
    lead-in and tail (ms) and their medians, then one JSON line of them
    all.  It uses only what the port's tree has had since its stage clock
    (``bench/stages.py``), so this script can run it on an earlier tree:
    copied into that tree's root, from there."""
    from gpuar_tpu_torch.bench.__main__ import (
        CELLS, DISK_FILES, corpus, disk_room)
    from gpuar_tpu_torch.parallel.runner import GPUCompressor

    gpu = GPUCompressor()
    out = {}
    for cell, rounds in EDGE_SHAPES:
        t0 = time.perf_counter()
        size = CELLS[cell]
        disk_room(WORK, DISK_FILES * size)
        src = WORK / "edges.bin"
        src.write_bytes(corpus(cell, size))
        want, archive = md5(src), None
        got = {v: {"gbps": [], "lead_in_ms": [], "tail_ms": []}
               for v in VERBS}
        for r in range(-1, rounds):   # round -1: warm-up, not kept
            files = [WORK / f"edges_{k}.{x}" for k in range(2)
                     for x in ("gip", "back")]
            for k, (gip, back) in enumerate((files[:2], files[2:])):
                for verb, a, b in (("compress", src, gip),
                                   ("decompress", gip, back)):
                    if k == 0:
                        t = time.perf_counter()
                        getattr(gpu, verb)(a, b)
                        sec = time.perf_counter() - t
                        if r >= 0:
                            got[verb]["gbps"].append(size / sec / 1e9)
                    else:
                        e = edge_run(gpu, verb, a, b)
                        if r >= 0:
                            got[verb]["lead_in_ms"].append(
                                e["lead_in_s"] * 1e3)
                            got[verb]["tail_ms"].append(e["tail_s"] * 1e3)
                digest = sha256(gip)
                archive = archive or digest
                if digest != archive or md5(back) != want:
                    raise AssertionError(f"{cell}: round {r} differs")
            # Unlinked outside the timed calls: every run writes new
            # files, none pays the truncation of an old one.
            for f in files:
                f.unlink()
        src.unlink()
        for verb, row in got.items():
            print(f"[{card}] edges {cell} {verb}, {rounds} rounds: "
                  + "; ".join(f"{k} median {float(np.median(v)):.6f} ["
                              + ", ".join(f"{x:.6f}" for x in v) + "]"
                              for k, v in row.items()), flush=True)
        out[cell] = got
        say(f"edges {cell}", f"{rounds} rounds, archives equal, md5 round "
            f"trips", t0)
    print(json.dumps({"edges": out}), flush=True)
    return out


def main_path_batch(raw: np.ndarray, b: int, n: int):
    """Super-batch b of the main path as a GPUCompressor of n-packet
    super-batches cuts it: up to n packets of P bytes, zero-padded, the
    last packet of the file ragged."""
    chunk = raw[b * n * P: (b + 1) * n * P]
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


def against_plain(dev, data: np.ndarray, sizes: np.ndarray, dense=None):
    """K1, G1, K2 and K3 on one batch's card tensors, each held against
    its plain version on the same tensors at 0 tolerance: K1 packets'
    first lengths[i] bytes and lengths; G1's body of K1's packets; K2
    output, K3 output and flags on
    ``dense`` (the batch as ``read_batch_dense`` read it from the
    archive: blob, byte offsets, comp_len, raw sizes; by default the
    dense blob of K1's packets, as a shard of one), and on the row blob
    of K1's packets against the same plain outputs; both outputs also
    against the data, and the debug flags must be clean.
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
    e_gat, _ = gather_err(pk, ln)
    plain_gat, _ = ms_of(lambda: encode.gather_body_plain(pk, ln))
    if dense is None:
        dense = blob_of(pk.cpu().numpy(), ln.cpu().numpy(), dense=True)
    blob, offs, comp_len, rs = dense
    args = (torch.from_numpy(blob).to(dev), torch.from_numpy(offs).to(dev),
            torch.from_numpy(rs).to(dev))
    rblob, roffs, _, _ = blob_of(pk.cpu().numpy(), ln.cpu().numpy())
    rargs = (torch.from_numpy(rblob).to(dev),
             torch.from_numpy(roffs).to(dev), args[2])
    rows = torch_codec.gather_regions(args[0], args[1], stride)
    out, rout = decode.decode_blob(*args), decode.decode_blob(*rargs)
    plain_dec, p_out = ms_of(
        lambda: torch_codec.decode_packets(rows, args[2], P))
    e_dec = max(max_abs_err(out, p_out), max_abs_err(rout, p_out),
                max_abs_err(out, d))
    out, flags = decode.decode_blob(*args, debug=True)
    rout, rflags = decode.decode_blob(*rargs, debug=True)
    plain_dbg, (p_out, p_flags) = ms_of(
        lambda: torch_codec.decode_packets(rows, args[2], P, debug=True))
    e_dbg = max(max_abs_err(out, p_out), max_abs_err(flags, p_flags),
                max_abs_err(rout, p_out), max_abs_err(rflags, p_flags),
                max_abs_err(out, d))
    decode.check_debug_flags(flags.cpu().numpy(), comp_len, len(rs))
    if e_enc or e_gat or e_dec or e_dbg:
        raise AssertionError(
            f"{list(data.shape)}: a kernel differs from its plain version "
            f"(max_abs_err K1 {e_enc}, G1 {e_gat}, K2 {e_dec}, K3 {e_dbg})")
    return ({"encode": e_enc, "gather": e_gat, "decode": e_dec,
             "decode_debug": e_dbg},
            {"encode": plain_enc, "gather": plain_gat, "decode": plain_dec,
             "decode_debug": plain_dbg})


SWEEP = (1, 132, 1024, 4096, 8192)   # packets of batch 0 in the sweep


def codec_shape() -> tuple[int, int]:
    """(threads per block, shared memory bytes per block) of the codec
    kernels' launch: K1, K2 and K3 all launch PacketModel's blocks, which
    gpuar_decode_shape reports."""
    from gpuar_tpu_torch.ops import _kernels

    return _kernels.launch_shape("gpuar_decode_shape")


def tiled(d, s, args, n: int):
    """The first n packets of batch 0, its packets repeated past its end:
    (data, sizes, (blob, offsets, raw sizes)) for K1 and K2/K3."""
    blob, offs, rs = args
    k = -(-n // d.shape[0])
    if k > 1:
        d, s, rs = d.repeat(k, 1), s.repeat(k), rs.repeat(k)
        offs = torch.cat([offs + i * blob.numel() for i in range(k)])
        blob = blob.repeat(k)
    return d[:n], s[:n], (blob, offs[:n], rs[:n])


def sweep(card, d, s, args) -> None:
    """K1, K2 and K3 on the first n packets of batch 0 (SWEEP, then one and
    two waves of the card, ``runner.batch_packets``, past batch 0's end by
    repeating its packets): a time that stays flat as n grows is one
    packet's chain (latency), one that grows with n the instruction rate or
    bandwidth."""
    from gpuar_tpu_torch import probes
    from gpuar_tpu_torch.ops import decode, encode
    from gpuar_tpu_torch.parallel import runner

    geometry = runner.launch_geometry(d.device)
    sizes = sorted({*SWEEP, *(runner.batch_packets(geometry, w)
                              for w in (1, 2))})
    runs = {"K1 encode": lambda t: encode.encode_batch(t[0], t[1]),
            "K2 decode": lambda t: decode.decode_blob(*t[2]),
            "K3 debug decode": lambda t: decode.decode_blob(*t[2],
                                                            debug=True)}
    for name, run in runs.items():
        ms = {}
        for n in sizes:
            t = tiled(d, s, args, n)
            ms[n] = probes.time_ms(lambda: run(t))
        times = ", ".join(f"n={n} {t:.4f} ms" for n, t in ms.items())
        print(f"[{card}] sweep {name}, first n packets of batch 0 "
              f"(repeated past its end): {times}; n={sizes[-1]} / n=1 "
              f"{ms[sizes[-1]] / ms[1]:.3f}", flush=True)


def row_compaction(packets: torch.Tensor, lengths: torch.Tensor,
                   row_bytes: int = 96):
    """The row compaction G1 replaced, timed beside it as the nearest
    library route (the port no longer calls it): each packet's whole
    96-byte rows gathered by PyTorch calls, a cumsum, a searchsorted and an
    index_select (``_compact_rows`` of gpuar_tpu/parallel/mesh.py, as the
    port ran it before G1), the host then splicing the padding out ->
    (blob [rows, row_bytes], row offsets int64 [n], total rows 0-d)."""
    n, stride = packets.shape
    rows_pp = stride // row_bytes
    cap = n * rows_pp
    rcnt = (lengths.to(torch.int64) + row_bytes - 1) // row_bytes
    ends = torch.cumsum(rcnt, 0)
    roff = ends - rcnt
    r = torch.arange(cap, dtype=torch.int64, device=packets.device)
    p = torch.searchsorted(ends, r, right=True).clamp_(max=n - 1)
    src = (p * rows_pp + (r - roff[p])).clamp_(0, cap - 1)
    return packets.reshape(cap, row_bytes).index_select(0, src), roff, \
        ends[-1]


def g1_times(card, dev, raw: np.ndarray, n: int):
    """G1 (with the offsets' cumsum it launches) on K1's packets of batch 0
    (random) and of the batch that holds the file's text (byte 80 MiB:
    the enwik8 and UTF-8 proxies), each at the card's batch of n packets
    and at one wave (the batch's packets repeated past its end), CUDA
    events, 20 launches a time; each held against its plain version at 0
    and timed beside it and the row compaction it replaced (whose rows,
    spliced on the host, must give G1's body).  The bound: each body byte
    read and written once, the lengths and offsets read.
    -> batch 0's (ms, plain ms, bound ms, bound by) at n."""
    from gpuar_tpu_torch import native
    from gpuar_tpu_torch.ops import encode
    from gpuar_tpu_torch.parallel import runner

    wave = runner.batch_packets(runner.launch_geometry(dev), 1)
    out = None
    for b, kind in ((0, "random"), ((80 * MIB) // (n * P), "text")):
        data, sizes = main_path_batch(raw, b, n)
        d, s = torch.from_numpy(data).to(dev), torch.from_numpy(sizes).to(dev)
        pk, ln = encode.encode_batch(d, s)
        del d, s
        for m in (n, wave):
            k = -(-m // pk.shape[0])
            mp, ml = pk.repeat(k, 1)[:m], ln.repeat(k)[:m]
            err, body = gather_err(mp, ml)
            if err:
                raise AssertionError(f"G1 differs from its plain version on "
                                     f"batch {b} at {m} packets: {err}")
            ms = timed(lambda: encode.gather_body(mp, ml), reps=20)
            rows_ms = timed(lambda: row_compaction(mp, ml), reps=20)
            plain_ms, _ = ms_of(lambda: encode.gather_body_plain(mp, ml))
            if m == n:
                blob, roff, _ = row_compaction(mp, ml)
                lens = ml.cpu().numpy()
                if not np.array_equal(native.splice_at(
                        blob.cpu().numpy().reshape(-1),
                        roff.cpu().numpy() * 96, lens), body.cpu().numpy()):
                    raise AssertionError("the row compaction, spliced, is "
                                         "not G1's body")
                del blob, roff
            t = body.numel()
            least, by = bound(2 * t + 12 * m, 0, INT32_OPS_PER_S)
            print(f"[{card}] G1 gather, batch {b} ({kind}) at {m} packets: "
                  f"{t} B body, {ms:.4f} ms ({t / ms / 1e6:.4f} GB/s), "
                  f"bound {least:.6f} ms ({by}), plain version "
                  f"{plain_ms:.4f} ms, row compaction {rows_ms:.4f} ms; "
                  f"max_abs_err 0", flush=True)
            if out is None:
                out = (ms, plain_ms, least, by)
            del mp, ml, body
        del pk, ln
        torch.cuda.empty_cache()
    return out


def phase5(card, dev, src, errs, n: int):
    """Each kernel on each of the main path's super-batches of n packets
    (phase 4's GPUCompressor's, sized from the card), CUDA events: K1 on
    the batch's bytes, K2 and K3 on its dense blob, which
    ``read_batch_dense`` reads from phase 4's archive as the drive loop
    does (at its block, into two buffers in turn, each batch's carry moved
    to the next), held on every batch to K2 and K3 on the row blob of
    K1's packets and to the data.  On batch 0 (full) and the last (ragged)
    each kernel is held against its plain version on the same card
    tensors at 0 tolerance (against_plain).  Then kernel against plain
    version at [32, 8192]."""
    from gpuar_tpu_torch import native
    from gpuar_tpu_torch.ops import decode, encode, torch_codec
    from gpuar_tpu_torch.pipeline import _PacketReader

    t0 = time.perf_counter()
    raw = np.fromfile(src, np.uint8)
    stride = encode.out_geometry(P)[1] * 4
    batch0 = {}
    last = (-(-raw.size // P) - 1) // n
    archive = ArchiveReads(WORK / "gpu.gip")
    reader = _PacketReader(archive)
    outs = [np.empty(reader.dense_capacity(n), np.uint8) for _ in range(2)]
    packet_ends, body_at = set(), 0
    for b in range(last + 1):
        tb = time.perf_counter()
        data, sizes = main_path_batch(raw, b, n)
        what = f"bytes [{b * n * P}, {b * n * P + int(sizes.sum())})" + (
            ", ragged" if b == last else "")
        d, s = torch.from_numpy(data).to(dev), torch.from_numpy(sizes).to(dev)
        ms_enc = timed(lambda: encode.encode_batch(d, s), reps=3)
        pk, ln = encode.encode_batch(d, s)
        carried = reader.carried
        dense = reader.read_batch_dense(n, outs[b % 2])
        blob, offs, comp_len, rs = dense
        if not (np.array_equal(rs, sizes)
                and np.array_equal(comp_len, ln.cpu().numpy())):
            raise AssertionError(f"dense batch {b} is not K1's packets")
        packet_ends.update((body_at + offs + comp_len).tolist())
        body_at += blob.size
        args = (torch.from_numpy(blob).to(dev),
                torch.from_numpy(offs).to(dev), torch.from_numpy(rs).to(dev))
        # The row blob of K1's packets: K2 and K3 give the same bytes and
        # flags on it as on the dense blob, and the data.  Both forms are
        # timed in turns (dense, rows, rows, dense), the means kept.
        rblob, roffs, _, _ = blob_of(pk.cpu().numpy(), ln.cpu().numpy())
        rargs = (torch.from_numpy(rblob).to(dev),
                 torch.from_numpy(roffs).to(dev), args[2])
        ms_form = {}
        for form, a in (("dense", args), ("rows", rargs), ("rows", rargs),
                        ("dense", args)):
            for debug in (False, True):
                ms_form.setdefault((form, debug), []).append(timed(
                    lambda: decode.decode_blob(*a, debug=debug), reps=3))
        ms_dec, ms_dbg = (float(np.mean(ms_form["dense", k]))
                          for k in (False, True))
        out, flags = decode.decode_blob(*args, debug=True)
        rout, rflags = decode.decode_blob(*rargs, debug=True)
        e_dense = max(max_abs_err(decode.decode_blob(*args),
                                  decode.decode_blob(*rargs)),
                      max_abs_err(out, rout), max_abs_err(flags, rflags),
                      max_abs_err(out, d))
        errs["decode"] = max(errs["decode"], e_dense)
        errs["decode_debug"] = max(errs["decode_debug"], e_dense)
        if e_dense:
            raise AssertionError(f"batch {b}: K2/K3 on the dense blob differ "
                                 f"from the row blob or the data")
        del rargs, out, flags, rout, rflags
        rows_ms = [float(np.mean(ms_form["rows", k])) for k in (False, True)]
        print(f"[{card}] batch {b} dense blob: {len(rs)} packets, "
              f"{blob.size} B (row blob {rblob.size} B), read by "
              f"read_batch_dense, {reader.carried - carried} B carried in "
              f"from batch {b - 1}; K2 and K3 equal them on the row blob "
              f"and the data (max_abs_err 0); in turns K2 {ms_dec:.4f} ms "
              f"dense, {rows_ms[0]:.4f} ms rows, K3 {ms_dbg:.4f} ms dense, "
              f"{rows_ms[1]:.4f} ms rows", flush=True)
        mb = int(sizes.sum()) / 1e6
        print(f"[{card}] batch {b} {list(data.shape)} ({what}): K1 "
              f"{ms_enc:.4f} ms ({mb / ms_enc:.4f} GB/s), K2 {ms_dec:.4f} ms "
              f"({mb / ms_dec:.4f} GB/s), K3 {ms_dbg:.4f} ms "
              f"({mb / ms_dbg:.4f} GB/s)", flush=True)
        if 0 < b < last:
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
            k = data.shape[0]
            nsym, upd = model_ops(data, sizes, 256)
            enc_bytes = int(sizes.sum()) + 8 * k + int(ln.sum())
            dec_bytes = blob.size + offs.nbytes + rs.nbytes + k * P
            refills = REFILL_OPS * (int(ln.sum()) // 4)
            bounds = {"encode": bound(enc_bytes, K1_SYMBOL_OPS * nsym,
                                      INT32_OPS_PER_S),
                      "decode": bound(dec_bytes, K2_SYMBOL_OPS * nsym
                                      + refills, INT32_OPS_PER_S),
                      "decode_debug": bound(dec_bytes + 8 * k,
                                            K3_SYMBOL_OPS * nsym + refills,
                                            INT32_OPS_PER_S)}
            flats = {"encode": bound(enc_bytes, upd + 16 * nsym),
                     "decode": bound(dec_bytes, upd + 24 * nsym),
                     "decode_debug": bound(dec_bytes + 8 * k,
                                           upd + 24 * nsym)}
            print(f"[{card}] batch 0 bounds, each kernel's operations at "
                  f"the integer rate: " + ", ".join(
                      f"{k} {bounds[k][0]:.6f} ms ({bounds[k][1]}; "
                      f"flat-table count at the float32 rate "
                      f"{flats[k][0]:.6f} ms)" for k in bounds), flush=True)
        del pk, ln, args
        e, plain = against_plain(dev, data, sizes, dense)
        for key in e:
            errs[key] = max(errs[key], e[key])
        if b == 0:
            batch0 = {key: (ms, plain[key], *bounds[key]) for key, ms in
                      (("encode", ms_enc), ("decode", ms_dec),
                       ("decode_debug", ms_dbg))}
        print(f"[{card}] batch {b} {list(data.shape)}: plain versions "
              f"K1 {plain['encode']:.4f} ms, G1 {plain['gather']:.4f} ms, "
              f"K2 {plain['decode']:.4f} ms, K3 {plain['decode_debug']:.4f} "
              f"ms; K1 packets and lengths, G1 body, K2 output, K3 output "
              f"and flags equal them (max_abs_err 0) and the data; debug "
              f"flags clean", flush=True)
        say(f"5 batch {b}", "kernels against plain versions done", tb)
        torch.cuda.empty_cache()

    # The dense reads: the archive ends with the last batch; some read
    # ended inside a packet (a packet straddled a block) and some batch's
    # reads ran past its last packet (a packet straddled a batch boundary
    # and came over as the carry).
    if reader.read_batch_dense(n, outs[(last + 1) % 2]) is not None:
        raise AssertionError("the archive holds more dense batches")
    mid = [e for e in archive.ends if e not in packet_ends]
    if not mid or not reader.carried:
        raise AssertionError(f"no packet straddled a read ({len(mid)}) or a "
                             f"batch ({reader.carried} B carried)")
    print(f"[{card}] dense reads: {last + 1} batches of up to {n} packets, "
          f"{len(archive.ends)} reads, {len(mid)} ending inside a packet, "
          f"{reader.carried} B carried over {body_at} B of archive body",
          flush=True)
    batch0["gather"] = g1_times(card, dev, raw, n)

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
        "gather": (lambda: encode.gather_body(pk, ln),
                   lambda: encode.gather_body_plain(pk, ln)),
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
    ("bench random_1g at 256 MiB",
     ["gpuar_tpu_torch.bench", "--cell", "random_1g", "--mib", "256",
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
    parser.add_argument("--sweep", action="store_true",
                        help="run only phases 0 and 1 and the launch-size "
                             "sweep over the benchmark cells' corpora")
    parser.add_argument("--edges", action="store_true",
                        help="run only phases 0 and 1 and the lead-in, "
                             "tail and GB/s of GPUCompressor() on the "
                             "benchmark cells' corpora")
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
    if opts.sweep or opts.edges:
        try:
            (launch_sweep if opts.sweep else edges)(CARD)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        say("done", "phases 0 and 1 and the "
            + ("launch sweep" if opts.sweep else "edges") + " passed", t_all)
        print(json.dumps({"ok": True, "device": device_line()}), flush=True)
        return 0
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
            times = phase5(CARD, dev, src, errs, gpu.super_batch_packets)
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
             "gather": ("G1 gather body", "gpuar_tpu_torch/csrc/gather.cu",
                        "gpuar_tpu/parallel/mesh.py:74 (_compact_rows, XLA, "
                        "and the host splice: no TPU kernel)"),
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
    print(json.dumps({"ok": True, "device": device_line()}), flush=True)
    return 0


def device_line() -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


if __name__ == "__main__":
    sys.exit(main())
