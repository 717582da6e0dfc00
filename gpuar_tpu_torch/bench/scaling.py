"""Weak scaling of ``--multihost``: N processes joined over torch.distributed
(gloo) drive DistributedCompressor over a shared file, fixed work per
process (the counterpart of ``benchmarks/scaling.py``).

    python -m gpuar_tpu_torch.bench.scaling [--mode c|d] [--per-host-mib 32]
        [--worlds 1,2,4] [--backend gpu|host|sleep] [--chip-gbps G]
        [--emulate-gib G] [--segments-per-host 16] [--reps 1]
        [--tmpdir DIR] [--json OUT]

Every world size codes the same bytes per process.  ``--mode c`` times
compress: per-process byte ranges -> local encode -> all-gather of the
compressed sizes -> exclusive-scan offsets -> parallel splice at the
offsets.  ``--mode d`` times decompress: rank 0 walks the archive's
packet index and broadcasts it in segments, each rank decodes the
segments it owns and writes them at their raw offsets; the archive is
made first by the same ranks, untimed, and afterwards this process checks
that the decoded file equals the input.  Perfect weak scaling is a flat
wall time.  The ranks are processes on this machine, joined as a user
joins them (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
each warms up on a small file (compress, and in mode d decompress), meets
the others at a barrier, then times one run of the verb.  A world whose
ranks have not all ended after ``WORKER_TIMEOUT_S``, or one of whose
ranks fails, is killed and raises with the ranks' output.

Backends: ``gpu`` (the default: GPUCompressor on every local card; the
ranks of a one-card machine share it, and each printed line says so),
``host`` (HostCompressor, one thread a rank) and ``sleep``
(``sleep_backend.SleepCompressor``: the codec sleeps bytes /
``--chip-gbps`` instead of computing, while the collectives, barriers,
index walk, offset scan, splice and file I/O run for real).  Without a
CUDA device ``gpu`` exits non-zero: pass ``--backend host`` or ``sleep``.

The sleep control's geometry: ``--segments-per-host`` sizes its
super-batch (``sleep_super_batch``) so each rank's body spans that many
decode segments, the count of a deployment with 1 GiB a host in 64 MiB
segments; ``--emulate-gib G`` makes each rank sleep as if it held G GiB
(``emulation``), while it moves only ``--per-host-mib`` real bytes.  The
gpu and host backends keep the default 8192-packet (64 MiB) super-batch.

Three efficiencies, as the JAX harness reports them:

  * wall_efficiency = wall_1 / wall_N: the real number where every
    process owns its own card and cores; on one machine the ranks share
    the cores (host) or the card (gpu), and the sleep control removes
    that sharing;
  * serialized_efficiency = N * wall_1 / wall_N: wall efficiency against
    the ideal time-sliced schedule of a shared machine;
  * projected_efficiency = t_chip / (t_chip + coord_N), with coord_N the
    slowest rank's coordination seconds and t_chip the per-process codec
    time at ``--chip-gbps`` (of ``--emulate-gib`` GiB where given).

coord is where the port's harness differs from the JAX one.  There it is
the residual wall - process - io.  The port's multi-host loops read and
write on a reader and a writer thread beside the loop's thread, and io
counts those threads' busy seconds, so io can pass wall - process and
the residual would clamp to 0 (a false projected efficiency of 1.0).  So
coord here is measured: the seconds the rank's loop thread spent in the
collectives, the barriers and the waits on the segment prefetcher
(``DistributedCompressor.coord``).  Each world's printed line also gives
the slowest rank's reader and writer busy seconds and ``cpu_total``.

``--chip-gbps`` has no default: pass the port's measured one-card rate of
the verb timed, ``compress_gbps`` or ``decompress_gbps`` of ``python -m
gpuar_tpu_torch.bench`` (PERF.md).  It is required with ``sleep``;
without it the projections are null.  ``--reps R`` runs each world R
times and keeps the run with the least wall time.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from gpuar_tpu_torch.config import UNCOMPRESSED_PACKET_SIZE

ROOT = Path(__file__).resolve().parents[2]   # holds gpuar_tpu_torch/
RUN_WORKER = ("import sys; from gpuar_tpu_torch.bench import scaling; "
              "scaling.worker(*sys.argv[1:])")
WORKER_TIMEOUT_S = 300
# The lanes' busy seconds: printed beside coord, kept out of the JSON
# (whose shape is the JAX harness's).
LANES = ("reader", "writer")
GIB = 1 << 30


def sleep_super_batch(per_host_bytes: int, segments_per_host: int) -> int:
    """The sleep control's super-batch in packets: each rank's body spans
    ``segments_per_host`` decode segments (``benchmarks/scaling.py``'s
    sizing)."""
    return max(per_host_bytes // max(segments_per_host, 1)
               // UNCOMPRESSED_PACKET_SIZE, 1)


def emulation(emulate_gib: float, per_host_bytes: int,
              chip_gbps: float) -> tuple[float, float]:
    """(time_scale, t_chip): the sleep control's factor from the bytes a
    rank moves to the ``emulate_gib`` GiB it emulates, and the codec
    seconds of that payload at ``chip_gbps``."""
    return (emulate_gib * GIB / per_host_bytes,
            emulate_gib * GIB / (chip_gbps * 1e9))


def worker(tmp: str, backend: str, chip_gbps: str, time_scale: str,
           mode: str, sleep_sbp: str) -> None:
    """One rank: join the world from the environment, warm up, meet at a
    barrier, time one compress (mode c) or decompress (mode d) of the
    shared file, and write ``rank{R}.json`` (wall, CPU, process, io,
    coordination and the reader's and writer's busy seconds)."""
    import resource

    import torch.distributed as dist

    from gpuar_tpu_torch.parallel import distributed

    distributed.initialize()
    rank, world = distributed.process_info()
    if backend == "host":
        from gpuar_tpu_torch.pipeline import HostCompressor
        be = HostCompressor()
    elif backend == "sleep":
        from gpuar_tpu_torch.bench.sleep_backend import SleepCompressor
        be = SleepCompressor(gbps=float(chip_gbps),
                             time_scale=float(time_scale),
                             super_batch_packets=int(sleep_sbp))
    else:
        from gpuar_tpu_torch.parallel.runner import GPUCompressor
        be = GPUCompressor()
    d = distributed.DistributedCompressor(backend=be)
    # Warm-up: one small compress, so one-time costs (the CUDA context and
    # kernel load, gloo's first collectives) fall before the timed region.
    d.compress(f"{tmp}/warm.bin", f"{tmp}/warm.gip")
    if mode == "d":
        # The archive (untimed, every rank cooperating), then a warm
        # decompress: decode has collectives of its own (the segment
        # stream's group and broadcasts).
        d.compress(f"{tmp}/in.bin", f"{tmp}/arch.gip")
        d.decompress(f"{tmp}/warm.gip", f"{tmp}/warmback.bin")
    if world > 1:
        dist.barrier()
    t0 = time.perf_counter()
    c0 = resource.getrusage(resource.RUSAGE_SELF)
    if mode == "d":
        info = d.decompress(f"{tmp}/arch.gip", f"{tmp}/back.bin")
    else:
        info = d.compress(f"{tmp}/in.bin", f"{tmp}/out.gip")
    wall = time.perf_counter() - t0
    c1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu = (c1.ru_utime - c0.ru_utime) + (c1.ru_stime - c0.ru_stime)
    res = dict(rank=rank, world=world, wall=wall, cpu=cpu,
               process=info.process_time, io=info.io_time,
               coord=d.coord.total, **d.lane_seconds)
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ranks(procs, logs: list[Path], timeout: float) -> None:
    """Wait for every rank; a rank that fails, or a world still running
    after ``timeout`` seconds, kills the rest and raises with the ranks'
    output."""
    deadline = time.monotonic() + timeout

    def tails(ranks):
        return "\n".join(f"--- rank {r}:\n{logs[r].read_text()[-3000:]}"
                         for r in ranks)

    try:
        while True:
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed:
                raise RuntimeError(
                    f"rank {failed[0]} exited {procs[failed[0]].returncode}:"
                    f"\n{tails(failed)}")
            running = [r for r, p in enumerate(procs) if p.poll() is None]
            if not running:
                return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"ranks {running} still running after {timeout} s "
                    f"(WORKER_TIMEOUT_S):\n{tails(range(len(procs)))}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_world(world: int, per_host_bytes: int, backend: str,
              chip_gbps: float | None = None,
              tmpdir: str | None = None, time_scale: float = 1.0,
              mode: str = "c", sleep_sbp: int = 8192) -> dict:
    """Ranks 0..world-1 of one world, each coding ``per_host_bytes`` of a
    random file (seed 0x5CA1E) -> the slowest rank's wall, coordination,
    process, io, reader and writer seconds, and the CPU seconds of all
    ranks.  In mode d the decoded file must equal the input."""
    import numpy as np

    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        rng = np.random.default_rng(0x5CA1E)
        with open(f"{tmp}/in.bin", "wb") as f:
            for _ in range(world):
                f.write(rng.integers(0, 256, per_host_bytes,
                                     np.uint8).tobytes())
        with open(f"{tmp}/warm.bin", "wb") as f:  # the warm-up corpus
            f.write(rng.integers(0, 256, world * 65536,
                                 np.uint8).tobytes())
        env = {**os.environ, "WORLD_SIZE": str(world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
        logs = [Path(tmp) / f"rank{r}.log" for r in range(world)]
        procs = []
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", RUN_WORKER, tmp, backend,
                     str(chip_gbps or 0.0), str(time_scale), mode,
                     str(sleep_sbp)],
                    cwd=ROOT, env={**env, "RANK": str(r)}, stdout=log,
                    stderr=subprocess.STDOUT))
        _wait_ranks(procs, logs, WORKER_TIMEOUT_S)
        if mode == "d" and not filecmp.cmp(f"{tmp}/in.bin",
                                           f"{tmp}/back.bin", shallow=False):
            raise RuntimeError(f"world {world}: the decoded file differs "
                               "from the input")
        ranks = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
    return {
        "world": world,
        "wall": max(r["wall"] for r in ranks),
        "coord": max(r["coord"] for r in ranks),
        "process": max(r["process"] for r in ranks),
        "io": max(r["io"] for r in ranks),
        **{lane: max(r[lane] for r in ranks) for lane in LANES},
        # CPU burned across ranks inside the timed region: the part that
        # serialises on a shared machine (the sleep control keeps it far
        # under the wall time).
        "cpu_total": sum(r["cpu"] for r in ranks),
    }


def efficiencies(rows: list[dict], chip_seconds: float | None,
                 chip_seconds_1gib: float | None) -> list[dict]:
    """Each world's row with its three efficiencies (module docstring);
    the projections are None without a card rate."""
    base = rows[0]["wall"]

    def projected(t, coord):
        return None if t is None else t / (t + coord)

    return [{**r,
             "wall_efficiency": base / r["wall"],
             "serialized_efficiency": r["world"] * base / r["wall"],
             "projected_efficiency": projected(chip_seconds, r["coord"]),
             "projected_efficiency_1gib_per_host":
                 projected(chip_seconds_1gib, r["coord"])}
            for r in rows]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m gpuar_tpu_torch.bench.scaling",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["c", "d"], default="c",
                    help="'c' times compress, 'd' decompress (the segmented "
                         "index walk's broadcasts are decode's extra "
                         "coordination)")
    ap.add_argument("--per-host-mib", type=float, default=32.0)
    ap.add_argument("--worlds", default="1,2,4")
    ap.add_argument("--backend", choices=["gpu", "host", "sleep"],
                    default="gpu",
                    help="'gpu' (default) needs a CUDA device; 'sleep' = "
                         "contention-free control: the codec sleeps bytes "
                         "/ --chip-gbps instead of computing, so the ranks "
                         "do not share cores or a card and wall_efficiency "
                         "measures the coordination cost of the real "
                         "collectives and splice")
    ap.add_argument("--chip-gbps", type=float, default=None,
                    help="one card's GB/s for the verb timed "
                         "(compress_gbps or decompress_gbps of python -m "
                         "gpuar_tpu_torch.bench): the sleep control's rate "
                         "and the projections' (required with sleep)")
    ap.add_argument("--emulate-gib", type=float, default=None,
                    help="sleep only: each rank sleeps as if it held this "
                         "many GiB while it moves --per-host-mib real bytes "
                         "(recorded as emulated_gib_per_host)")
    ap.add_argument("--segments-per-host", type=int, default=16,
                    help="sleep only: size the control's super-batch so "
                         "each rank's body spans this many decode segments "
                         "(1 GiB a host in 64 MiB segments is 16)")
    ap.add_argument("--reps", type=int, default=1,
                    help="run each world this many times, keep the run "
                         "with the least wall time")
    ap.add_argument("--tmpdir", default=None,
                    help="working directory for the corpus and archives "
                         "(default: the system's temporary directory)")
    ap.add_argument("--json", default=None, help="also write results here")
    args = ap.parse_args(argv)
    if args.backend == "sleep" and args.chip_gbps is None:
        ap.error("--backend sleep needs --chip-gbps (the card's measured "
                 "rate: compress_gbps or decompress_gbps of python -m "
                 "gpuar_tpu_torch.bench)")
    if args.emulate_gib is not None and args.backend != "sleep":
        ap.error("--emulate-gib requires --backend sleep")
    if args.backend == "gpu":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("gpuar_tpu_torch.bench.scaling: --backend gpu "
                             "(the default) needs a CUDA device; pass "
                             "--backend host or --backend sleep to run "
                             "without one")
        cards = torch.cuda.device_count()

    per_host = int(args.per_host_mib * (1 << 20))
    worlds = [int(w) for w in args.worlds.split(",")]
    reps = max(args.reps, 1)
    shared = os.cpu_count() is not None and os.cpu_count() < max(worlds)
    gbps = args.chip_gbps
    t_chip = None if gbps is None else per_host / (gbps * 1e9)
    t_chip_1g = None if gbps is None else GIB / (gbps * 1e9)
    sleep_sbp = 8192
    if args.backend == "sleep":
        sleep_sbp = sleep_super_batch(per_host, args.segments_per_host)
    time_scale = 1.0
    if args.emulate_gib is not None:
        time_scale, t_chip = emulation(args.emulate_gib, per_host, gbps)

    rows = []
    for w in worlds:
        runs = [run_world(w, per_host, args.backend, chip_gbps=gbps,
                          tmpdir=args.tmpdir, time_scale=time_scale,
                          mode=args.mode, sleep_sbp=sleep_sbp)
                for _ in range(reps)]
        r = min(runs, key=lambda x: x["wall"])
        lanes = " ".join(f"{k}={r.pop(k):.6f}s" for k in LANES if k in r)
        rows.append(r)
        note = ""
        if args.backend == "gpu" and w > cards:
            note = (f"; {w} ranks share {cards} card(s): not a scaling "
                    "figure")
        print(f"world={w}: wall={r['wall']:.6f}s "
              f"process={r['process']:.6f}s io={r['io']:.6f}s "
              f"coord={r['coord']:.6f}s {lanes} "
              f"cpu_total={r['cpu_total']:.6f}s (min of {reps}{note})",
              flush=True)

    out = {
        "metric": "weak scaling (fixed per-host work)",
        "mode": args.mode,
        "backend": args.backend,
        "per_host_bytes": per_host,
        "emulated_gib_per_host": args.emulate_gib,
        "shared_machine": shared,
        "chip_gbps_assumed": gbps,
        "worlds": efficiencies(rows, t_chip, t_chip_1g),
    }
    if args.backend == "gpu":
        from gpuar_tpu_torch.probes import card

        out["card"] = card()
        out["cards"] = cards
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
