"""Where one run of the drive loops spends its wall: stages by thread, and
the card's idle gaps.

A stage-timed run is one ``GPUCompressor.compress`` or ``.decompress``
with a span around each call into a layer, put in from outside the
program (``mock.patch`` for the run, undone after it; no profiler):

  * host stages, by the host clock (``time.perf_counter``) on the thread
    that makes the call: the drive loop's own (``MainThread``: the
    opening and closing of the files, the wait for the slot's upload
    buffer, the submit, the fetch, the splice, and its waits on the
    reader and writer lanes), the reader's (``gpuar-reader``: the file's
    read, and decompress's header walk and carry, with the carry's bytes)
    and the writer's (``gpuar-writer``: the write);
  * device stages, by CUDA events recorded on the codec's streams before
    and after the call that enqueues the work: compress's upload, K1, G1
    (the body's gather, the stage's "compaction") and length download on
    the batch stream, and its body download (``D2H``: the copy
    ``DeviceCodec.encode_body_wait`` enqueues on the fetch stream);
    decompress's upload, K2 and download.  Every copy and kernel the
    loops enqueue falls inside one.  An anchor event, recorded beside
    the host clock right after a synchronise at the run's start, puts the
    device stages on the host clock.

On a CPU device the clock records host stages only.  ``attribute`` turns
the intervals into the card's busy and idle seconds, its longest idle
gaps with what each thread was doing in them, and the idle seconds by
the loop's stage; it is a plain function of the intervals.
"""

from __future__ import annotations

import contextlib
import threading
import time
from unittest import mock

import torch

COMPRESS_STAGES = ["open", "read", "buffer wait", "submit",
                   "H2D + K1 + compaction", "D2H", "fetch", "splice",
                   "write", "close"]
DECOMPRESS_STAGES = ["open", "read", "walk", "carry", "buffer wait",
                     "submit", "H2D + K2 + D2H", "fetch", "write", "close"]
STAGES = {"compress": COMPRESS_STAGES, "decompress": DECOMPRESS_STAGES}

# The drive loops' threads (``pipeline._Lane`` names its own) -> label.
THREADS = (("MainThread", "main"), ("gpuar-reader", "reader"),
           ("gpuar-writer", "writer"))
# The loop's stages that ``idle_by_loop_stage`` sums the card's idle
# seconds by; time in none of them is "none".
LOOP_STAGES = ("wait on reader", "wait on writer", "submit", "fetch",
               "splice", "buffer wait", "open", "close")
GAPS = 5   # idle gaps a breakdown lists, the longest first
# Host stages whose call returns the bytes it moved, summed beside their
# seconds: the dense reader's carry (``_PacketReader._carry_in``).
BYTE_STAGES = ("carry",)


def _on_fetch_stream(codec) -> bool:
    """Whether the codec's call is enqueued on its fetch stream (the body
    download in ``encode_body_wait``; its other downloads go on the batch
    stream, inside the batch's device stage)."""
    return (torch.cuda.current_stream(codec.device).cuda_stream
            == codec._fetch_stream.cuda_stream)


def hooks(verb: str, compressor: type) -> list[tuple]:
    """The verb's stage hooks on a run of ``compressor`` (GPUCompressor
    or a subclass): [(kind "host", "lane" or "device", owner, attribute,
    stage, the device stage's stream attribute, the condition on the
    codec under which a call is a device stage)]."""
    from gpuar_tpu_torch import native, pipeline
    from gpuar_tpu_torch.parallel.codec import DeviceCodec
    from gpuar_tpu_torch.parallel.mesh import MeshCodec

    common = [("host", MeshCodec, "_staging", "buffer wait", None, None),
              ("lane", pipeline._Lane, "wait", "wait on <lane>", None, None)]
    if verb == "compress":
        return [("device", DeviceCodec, "encode_body_async",
                 "H2D + K1 + compaction", "_stream", None),
                ("device", DeviceCodec, "_download", "D2H", "_fetch_stream",
                 _on_fetch_stream),
                *common,
                ("host", compressor, "encode_submit", "submit", None, None),
                ("host", DeviceCodec, "encode_body_wait", "fetch", None,
                 None),
                # The GPU path splices nothing since G1 (the body comes
                # down as it lies in the file): "splice" reads 0.
                ("host", native, "splice_at", "splice", None, None)]
    return [("device", DeviceCodec, "decode_blob_async", "H2D + K2 + D2H",
             "_stream", None),
            *common,
            ("host", native, "walk_packets", "walk", None, None),
            ("host", pipeline._PacketReader, "_carry_in", "carry", None,
             None),
            ("host", compressor, "decode_submit_blob", "submit", None, None),
            ("host", MeshCodec, "decode_body_wait", "fetch", None, None)]


class StageClock:
    """The spans of one run: host spans (thread, stage, start, end) and
    device stages' CUDA events, with each device's anchor."""

    def __init__(self):
        self.spans: list[tuple[str, str, float, float]] = []
        self.events: dict[str, list] = {}   # stage -> [(device, start, end)]
        self.anchors: dict[int, tuple] = {}  # device -> (event, host s)
        self.moved: dict[str, int] = {}   # BYTE_STAGES' stage -> bytes
        self.t0 = self.t1 = 0.0
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, stage: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                self.spans.append((threading.current_thread().name, stage,
                                   t, end))

    def host_stage(self, owner, attr: str, stage: str):
        fn = getattr(owner, attr)

        def timed_call(*args, **kw):
            with self.span(stage):
                out = fn(*args, **kw)
            if stage in BYTE_STAGES:
                with self._lock:
                    self.moved[stage] = self.moved.get(stage, 0) + out
            return out
        return mock.patch.object(owner, attr, timed_call)

    def lane_waits(self, owner):
        """The drive loop's waits on a lane (``_Lane.wait``, also inside
        ``start``) as the stage "wait on <lane>"."""
        wait = owner.wait

        def timed_wait(lane):
            with self.span(f"wait on {lane.name}"):
                return wait(lane)
        return mock.patch.object(owner, "wait", timed_wait)

    def device_stage(self, owner, attr: str, stage: str,
                     stream: str = "_stream", when=None):
        """CUDA events on the codec's ``stream`` around the call, where
        ``when(codec)`` holds (if given); a CPU codec's call runs
        untimed."""
        fn = getattr(owner, attr)

        def timed_call(codec, *args, **kw):
            if not codec._cuda or (when is not None and not when(codec)):
                return fn(codec, *args, **kw)
            on = getattr(codec, stream)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record(on)
            out = fn(codec, *args, **kw)
            end.record(on)
            with self._lock:
                self.events.setdefault(stage, []).append(
                    (codec.device.index, start, end))
            return out
        return mock.patch.object(owner, attr, timed_call)

    def timed_open(self):
        """``open`` for the pipeline module: the open counts as the open
        stage (truncating an output that exists), its files' readinto and
        read as the read stage, their write as the write stage and their
        close as the close stage, on the thread that calls them."""
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

            def close(self):
                with clock.span("close"):
                    self._f.close()

            def __getattr__(self, name):
                return getattr(self._f, name)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.close()

        def timed(*args, **kw):
            with clock.span("open"):
                return TimedFile(open(*args, **kw))
        return timed

    @contextlib.contextmanager
    def hooked(self, verb: str, compressor: type):
        """Every hook of ``hooks(verb, compressor)`` and the timed
        ``open``, undone on exit."""
        from gpuar_tpu_torch import pipeline

        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                pipeline, "open", self.timed_open(), create=True))
            for kind, owner, attr, stage, stream, when in hooks(
                    verb, compressor):
                if kind == "device":
                    hook = self.device_stage(owner, attr, stage, stream,
                                             when)
                elif kind == "lane":
                    hook = self.lane_waits(owner)
                else:
                    hook = self.host_stage(owner, attr, stage)
                stack.enter_context(hook)
            yield

    def start(self, devices) -> None:
        """Synchronise ``devices`` (CUDA device indices), then note the
        run's start and each device's anchor beside the host clock."""
        for d in devices:
            torch.cuda.synchronize(d)
        self.t0 = time.perf_counter()
        for d in devices:
            anchor = torch.cuda.Event(enable_timing=True)
            host = time.perf_counter()
            anchor.record(torch.cuda.current_stream(d))
            self.anchors[d] = (anchor, host)

    def stop(self) -> None:
        for d in self.anchors:
            torch.cuda.synchronize(d)
        self.t1 = time.perf_counter()

    def device_intervals(self) -> list[tuple[str, float, float]]:
        """[(stage, start, end)] on the host clock (after ``stop``)."""
        out = []
        for stage, evs in self.events.items():
            for d, a, b in evs:
                anchor, host = self.anchors[d]
                out.append((stage, host + anchor.elapsed_time(a) / 1e3,
                            host + anchor.elapsed_time(b) / 1e3))
        return out

    def stage_ms(self, stage: str) -> list[float]:
        """Each of the device stage's intervals, ms (after ``stop``)."""
        return [a.elapsed_time(b) for _, a, b in self.events.get(stage, [])]

    def summary(self) -> dict:
        """The run as plain numbers (``summarize``)."""
        return summarize(self.t0, self.t1, self.spans,
                         self.device_intervals(), self.moved)


def stage_run(gpu, verb: str, src, dst) -> dict:
    """One ``gpu.compress(src, dst)`` or ``gpu.decompress(src, dst)`` with
    its stages timed -> its ``summarize`` dict.  Every patch is undone
    before it returns."""
    devices = sorted({c.device.index for c in gpu.codec.codecs
                      if c.device.type == "cuda"})
    clock = StageClock()
    with clock.hooked(verb, type(gpu)):
        clock.start(devices)
        getattr(gpu, verb)(src, dst)
        clock.stop()
    return clock.summary()


# --- the intervals as numbers (plain functions; the CPU tests drive them)


def merge(intervals) -> list[tuple[float, float]]:
    """[(start, end)] -> their union as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(t0: float, t1: float, busy) -> list[tuple[float, float]]:
    """The intervals of [t0, t1] that no interval of ``busy`` covers."""
    out, at = [], t0
    for a, b in merge((max(a, t0), min(b, t1)) for a, b in busy
                      if b > t0 and a < t1):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out


def timeline(spans) -> list[tuple[float, float, str]]:
    """[(stage, start, end)] of one thread -> disjoint (start, end, stage)
    pieces of the time they cover; where spans nest, the innermost (the
    latest start) holds the piece."""
    cuts = sorted({t for _, a, b in spans for t in (a, b)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        inside = [(s, -e, st) for st, s, e in spans if s <= a and e >= b]
        if inside:
            out.append((a, b, max(inside)[2]))
    return out


def shares(a: float, b: float, pieces) -> dict[str, float]:
    """Seconds of [a, b] that each stage of a ``timeline`` holds, and
    "none" for the rest."""
    out: dict[str, float] = {}
    for s, e, st in pieces:
        cut = min(b, e) - max(a, s)
        if cut > 0:
            out[st] = out.get(st, 0.0) + cut
    out["none"] = (b - a) - sum(out.values())
    return out


def attribute(t0: float, t1: float, device, threads: dict,
              top: int = GAPS) -> dict:
    """The card's busy and idle time in the run [t0, t1].  ``device``:
    the device stages' [(start, end)]; ``threads``: {label: [(stage,
    start, end)]}, "main" the drive loop's.  -> {"wall_s", "device_s"
    (the union of ``device`` within the run), "device_share" (its share
    of the wall), "idle_s" (the rest of the wall), "lead_in_s" (the
    run's start to the first device stage's, None with none),
    "idle_gaps" (the ``top`` longest gaps, the longest first: "start_ms"
    from the run's start, "ms", and for each thread the stage that holds
    most of the gap, "none" where no stage does), "idle_by_loop_stage" (the idle seconds by the loop's stage, "none"
    where it is in none)}."""
    busy = merge((max(a, t0), min(b, t1)) for a, b in device
                 if b > t0 and a < t1)
    idle = gaps(t0, t1, busy)
    pieces = {label: timeline(spans) for label, spans in threads.items()}
    rows = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:top]:
        row = {"start_ms": (a - t0) * 1e3, "ms": (b - a) * 1e3}
        for label, p in pieces.items():
            got = shares(a, b, p)
            row[label] = max(got, key=got.get)
        rows.append(row)
    by_loop = dict.fromkeys((*LOOP_STAGES, "none"), 0.0)
    for a, b in idle:
        for st, sec in shares(a, b, pieces.get("main", [])).items():
            key = st if st in by_loop else "none"
            by_loop[key] += sec
    device_s = sum(b - a for a, b in busy)
    return {"wall_s": t1 - t0, "device_s": device_s,
            "device_share": device_s / (t1 - t0) if t1 > t0 else 0.0,
            "idle_s": sum(b - a for a, b in idle),
            "lead_in_s": busy[0][0] - t0 if busy else None,
            "idle_gaps": rows, "idle_by_loop_stage": by_loop}


def summarize(t0: float, t1: float, spans, device, moved=None) -> dict:
    """One run -> ``attribute``'s numbers plus "threads" ({label: {stage:
    [s, count]}}), "device" ({stage: [s, count]}, each interval's length
    summed; they may overlap) and "bytes" (``moved``: {stage of
    BYTE_STAGES: bytes})."""
    threads: dict[str, list] = {label: [] for _, label in THREADS}
    names = dict(THREADS)
    for thread, stage, a, b in spans:
        if thread in names:
            threads[names[thread]].append((stage, a, b))
    out = attribute(t0, t1, [(a, b) for _, a, b in device], threads)
    out["threads"] = {label: _sums((st, b - a) for st, a, b in mine)
                      for label, mine in threads.items()}
    out["device"] = _sums((st, b - a) for st, a, b in device)
    out["bytes"] = dict(moved or {})
    return out


def _sums(pairs) -> dict[str, list]:
    out: dict[str, list] = {}
    for stage, sec in pairs:
        acc = out.setdefault(stage, [0.0, 0])
        acc[0] += sec
        acc[1] += 1
    return out


def line(run: dict, order: list[str]) -> str:
    """One run's ``summarize`` dict as a line: the wall; each thread's
    stages in ``order`` (a BYTE_STAGES stage with its bytes), then its
    waits, its busy sum (and, on the main thread, the rest of the wall);
    the device stages (CUDA events); the card's busy union, idle seconds
    and the lead-in."""
    wall = run["wall_s"]
    parts = [f"wall {wall:.6f} s"]
    for _, label in THREADS:
        mine = run["threads"][label]
        stages = [st for st in order if st in mine] \
            + sorted(st for st in mine if st.startswith("wait on"))
        busy = sum(mine[st][0] for st in stages)
        rest = f", rest {wall - busy:.6f} s" if label == "main" else ""
        moved = run.get("bytes", {})
        parts.append(f"{label}: " + ", ".join(
            f"{st} {mine[st][0]:.6f} s x{mine[st][1]}"
            + (f" {moved[st]} B" if st in moved else "") for st in stages)
            + f" (sum {busy:.6f} s{rest})")
    for stage in order:
        if stage in run["device"]:
            sec, n = run["device"][stage]
            parts.append(f"device: {stage} {sec:.6f} s x{n} (CUDA events)")
    lead = run["lead_in_s"]
    parts.append(f"card busy {run['device_s']:.6f} s, idle "
                 f"{run['idle_s']:.6f} s, lead-in "
                 + ("none" if lead is None else f"{lead:.6f} s"))
    return "; ".join(parts)
