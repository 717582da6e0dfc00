"""The port's --multihost loops on three threads, and each owned segment's
dense blob read into the upload buffer the backend hands out.

``DistributedCompressor`` reads on a reader thread and writes on a writer
thread (``pipeline._Lane``) while its own thread submits, fetches and runs
the collectives.  Here, on the CPU: a segment's dense blob read into a
poisoned buffer holds the segment's body, decodes to what the JAX
package's row blob decodes to and allocates nothing; it is read into the
buffer ``decode_blob_buffer`` hands out and uploaded from it with no
copy; worlds of 1 (a FileStore world of one), 2 and 3 run
the threaded loops over a backend whose buffers are poisoned when handed
out and when their slot is taken again, with slowed lanes, and write the
JAX package's archive; faults on either lane, and a body cut mid-packet,
surface as raised with no loop thread left and every rank ended; and the
scaling harness's ``coord`` is measured, not a clamped residual.
"""

import errno
import io
import json
import subprocess
import sys
import textwrap
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from gpuar_tpu_torch import container
from gpuar_tpu_torch import native as port_native
from gpuar_tpu_torch.bench import scaling
from gpuar_tpu_torch.parallel import distributed
from gpuar_tpu_torch.config import COMPRESSED_PACKET_SIZE
from gpuar_tpu_torch.parallel.codec import DeviceCodec
from gpuar_tpu_torch.parallel.runner import GPUCompressor
from gpuar_tpu_torch.pipeline import HostCompressor as PortHost
from test_torch_host import jax_native
from test_torch_pipeline import (
    _jax_archive,
    bounded,
    loop_threads,
    one_torch_thread,  # noqa: F401  (a fixture)
)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
P = 8192
POISON = 0xAB


@pytest.fixture(scope="module", autouse=True)
def _jax_golden():
    """The JAX package's golden codec (an oracle here), loaded first with
    the bounded retry of ``jax_native``."""
    jax_native()


@pytest.fixture(autouse=True)
def _world_of_one(monkeypatch):
    """In-process calls run as a world of one (no group, no environment)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)


def _framed(bodies) -> bytes:
    return b"".join((len(b) + 4).to_bytes(2, "little")
                    + len(b).to_bytes(2, "little") + b for b in bodies)


def _segment_body(shape: str) -> bytes:
    """A segment's back-to-back framed packets of the named shape."""
    rng = np.random.default_rng(len(shape))
    if shape == "one packet":
        return _framed([rng.integers(0, 256, 37, np.uint8).tobytes()])
    if shape == "ragged last packet":
        return _framed([rng.integers(0, 256, n, np.uint8).tobytes()
                        for n in (300, 95, 1000, 17)])
    if shape == "exact rows":
        # Framed totals of exactly 1, 2 and 3 rows of 96 B: no row tail.
        return _framed([bytes([i]) * (96 * (i + 1) - 4) for i in range(3)])
    # A full segment at P = 64: 256 packets of the golden codec.
    data = rng.integers(0, 256, 256 * 64, np.uint8)
    data[: 64 * 100] = 5
    return port_native.encode_stream(data, 64)


@pytest.mark.parametrize("shape", ["one packet", "ragged last packet",
                                   "exact rows", "full segment at P = 64"])
def test_dense_segment_blob_in_a_poisoned_buffer_decodes_as_the_rows(shape):
    """A segment's dense blob read into a buffer filled with 0xAB is the
    segment's body at the head of the buffer, each packet at its walked
    byte offset with the bytes the JAX package's row blob holds at its
    row; the bytes past it are left alone; the load allocates nothing;
    and a segment of coded packets decodes (DeviceCodec on the CPU) to
    what the row blob decodes to."""
    from gpuar_tpu.parallel import distributed as jax_side

    body = _segment_body(shape)
    seg = distributed.walk_packet_index(io.BytesIO(body), len(body))
    out = np.full(256 * COMPRESSED_PACKET_SIZE, POISON, np.uint8)
    view = distributed._BodyView(io.BytesIO(body), 0)
    tracemalloc.start()
    try:
        blob, offsets, clen, raw = distributed._load_segment_blob(
            view, seg, out)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # Python's own small objects and the index arrays only: a copy of the
    # body would be at least its size (numpy's arrays are traced).
    assert peak < 16384 + 16 * len(clen), f"the load allocated {peak} B"
    assert blob.ctypes.data == out.ctypes.data and blob.tobytes() == body
    assert (out[len(body):] == POISON).all()
    assert offsets.dtype == np.int64
    np.testing.assert_array_equal(offsets, seg[0, :-1] - seg[0, 0])
    rows, roff, rlen, rraw = jax_side._load_segment_blob(
        jax_side._BodyView(io.BytesIO(body), 0), seg, 96, 64)
    np.testing.assert_array_equal(clen, rlen)
    np.testing.assert_array_equal(raw, rraw)
    for i, (o, n) in enumerate(zip(offsets, clen)):
        assert blob[o: o + n].tobytes() == \
            rows[roff[i] * 96: roff[i] * 96 + n].tobytes(), f"packet {i}"
    if shape == "full segment at P = 64":
        codec = DeviceCodec(CPU, packet_size=64)
        want = codec.decode_body_wait(codec.decode_blob_async(
            rows, roff.astype(np.int64) * 96, rlen, rraw)).copy()
        got = codec.decode_body_wait(codec.decode_blob_async(
            blob, offsets, clen, raw))
        np.testing.assert_array_equal(got, want)
        assert got.tobytes() == port_native.decode_stream(body, 256 * 64)
    with pytest.raises(ValueError, match="segment needs"):
        distributed._load_segment_blob(view, seg, out[: len(body) - 1])


def test_expand_at_refuses_offsets_out_of_order():
    """The stride loader's scatter needs offsets that ascend without
    overlap (it zeroes the gaps between them)."""
    body = np.arange(30, dtype=np.uint8)
    lengths = np.array([10, 10, 10], np.int32)
    for offsets in ([20, 0, 40], [0, 5, 40]):
        with pytest.raises(ValueError, match="not ascending"):
            port_native.expand_at(body, np.array(offsets), lengths, 64)
    blob = port_native.expand_at(body, np.array([0, 16, 40]), lengths, 64)
    assert blob[:16].tolist() == list(range(10)) + [0] * 6


def test_read_segment_reads_into_the_reused_array():
    """``_read_segment`` reads each segment's body into the array it is
    given (a view of its head), and a body cut short still raises."""
    body = _segment_body("ragged last packet")
    segs = list(distributed.walk_packet_index_chunks(
        io.BytesIO(body), len(body), 2))
    data = np.full(4096, POISON, np.uint8)
    for seg in segs:
        got, clen, raw = distributed._read_segment(
            distributed._BodyView(io.BytesIO(body), 0), seg, data)
        assert got.ctypes.data == data.ctypes.data
        assert got.tobytes() == body[int(seg[0, 0]): int(seg[0, -1])]
        np.testing.assert_array_equal(clen, np.diff(seg[0]))
    with pytest.raises(container.ContainerError, match="truncated packet"):
        distributed._read_segment(
            distributed._BodyView(io.BytesIO(body[:-3]), 0), segs[-1], data)


def test_segment_blob_built_in_the_handed_buffer_goes_up_without_a_copy(
        monkeypatch):
    """On a CPU device, the dense blob ``_load_segment_blob`` reads into
    the buffer ``decode_blob_buffer`` handed out shares its memory, and
    ``MeshCodec._staged`` uploads that buffer itself (no copy); the
    decode equals the packets' raw bytes."""
    from gpuar_tpu_torch.parallel.mesh import MeshCodec

    data = np.random.default_rng(0xB10B).integers(0, 256, 5 * 64 + 9,
                                                  np.uint8)
    data[64: 192] = 1
    body = port_native.encode_stream(data, 64)
    seg = distributed.walk_packet_index(io.BytesIO(body), len(body))
    be = GPUCompressor(devices=[CPU, CPU], packet_size=64,
                       super_batch_packets=8)
    handed = be.decode_blob_buffer(8 * COMPRESSED_PACKET_SIZE)
    handed.fill(POISON)
    loaded = distributed._load_segment_blob(
        distributed._BodyView(io.BytesIO(body), 0), seg, handed)
    assert np.shares_memory(loaded[0], handed)
    assert loaded[0].ctypes.data == handed.ctypes.data
    staged, stage = [], MeshCodec._staged

    def recording(self, name, i, arr):
        t = stage(self, name, i, arr)
        staged.append((name, t.data_ptr()))
        return t

    monkeypatch.setattr(MeshCodec, "_staged", recording)
    raw = be.decode_fetch(be.decode_submit_blob(*loaded))
    assert staged == [("blob", handed.ctypes.data)]
    assert raw.reshape(-1)[: data.size].tobytes() == data.tobytes()


def test_multihost_dense_decompress_scatters_nothing(tmp_path, monkeypatch,
                                                     one_torch_thread):
    """A world of one over GPUCompressor on two CPU shards, segments of
    100 packets at P = 64: decompress calls no ``expand_at`` (each
    segment is read into the handed buffer as it lies in the archive)
    and writes what HostCompressor's decompress writes."""
    data = np.random.default_rng(0xD5E).integers(0, 256, 333 * 64 + 17,
                                                 np.uint8)
    data[64 * 50: 64 * 150] = 4
    src, gip = tmp_path / "in.bin", tmp_path / "in.gip"
    src.write_bytes(data.tobytes())
    gip.write_bytes(_jax_archive(data.tobytes(), 64))
    PortHost(super_batch_packets=100).decompress(gip, tmp_path / "host.bin")

    def scatter(*args, **kw):
        raise AssertionError("expand_at on the dense path")

    monkeypatch.setattr(port_native, "expand_at", scatter)
    d = distributed.DistributedCompressor(backend=GPUCompressor(
        devices=[CPU, CPU], packet_size=64, super_batch_packets=100))
    bounded(d.decompress, gip, tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == \
        (tmp_path / "host.bin").read_bytes() == data.tobytes()


@pytest.mark.gpu
def test_gpu_multihost_decompress_uploads_the_handed_pinned_blob(
        tmp_path, monkeypatch):
    """On the card, a world of one over GPUCompressor at 8192 B, three
    segments of up to two packets: the archive equals the host codec's,
    the round trip is exact, and every segment's blob goes up from the
    pinned buffer ``decode_blob_buffer`` handed out, with no host copy."""
    from gpuar_tpu_torch.parallel.mesh import MeshCodec

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = np.random.default_rng(0x6B0).integers(0, 256, 4 * P + 999,
                                                  np.uint8)
    data[P: 2 * P] = 2
    src, gip = tmp_path / "in.bin", tmp_path / "gpu.gip"
    src.write_bytes(data.tobytes())
    PortHost().compress(src, tmp_path / "host.gip")
    d = distributed.DistributedCompressor(backend=GPUCompressor(
        devices=[torch.device("cuda", 0)], super_batch_packets=2))
    bounded(d.compress, src, gip)
    assert gip.read_bytes() == (tmp_path / "host.gip").read_bytes()
    handed, staged = [], []
    hand, stage = MeshCodec.blob_buffer, MeshCodec._staged

    def handing(self, nbytes):
        buf = hand(self, nbytes)
        handed.append(buf.ctypes.data)
        return buf

    def staging(self, name, i, arr):
        t = stage(self, name, i, arr)
        staged.append((name, t.data_ptr(), t.is_pinned()))
        return t

    monkeypatch.setattr(MeshCodec, "blob_buffer", handing)
    monkeypatch.setattr(MeshCodec, "_staged", staging)
    bounded(d.decompress, gip, tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()
    assert staged == [("blob", ptr, True) for ptr in handed]
    assert len(staged) == 3


# --- worlds through the threaded loops ---------------------------------------

_POISON_WORKER = textwrap.dedent("""
    import json, sys, time
    rank, world, store, tmp, repo = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(1)
    from gpuar_tpu_torch import pipeline
    from gpuar_tpu_torch.parallel import distributed
    from gpuar_tpu_torch.parallel.mesh import MeshCodec
    from gpuar_tpu_torch.parallel.runner import GPUCompressor

    POISON = 0xAB
    hand, take = MeshCodec._hand, MeshCodec._slot
    poisoned = {"handed": 0, "reused": 0}

    def poisoned_hand(self, name, nbytes):
        # The buffer the reader builds the next batch in.
        buf = hand(self, name, nbytes)
        buf.fill(POISON)
        poisoned["handed"] += 1
        return buf

    def poisoned_slot(self):
        # The slot a submit takes: every buffer but the one the reader
        # just filled held the batch of two submits back, which must be
        # written by now (the decoded batch, the spliced body).
        kept = self._handed[0] if self._handed else None
        slot = take(self)
        for name, buf in slot.bufs.items():
            if name != kept:
                buf.fill_(POISON)
                poisoned["reused"] += 1
        return slot

    class SlowLane(pipeline._Lane):
        # Every read and write starts late, so a buffer reused too early
        # would be poisoned before the lane reads or writes it.
        def start(self, fn, *args):
            def slow(*a):
                time.sleep(0.002)
                return fn(*a)
            super().start(slow, *args)

    MeshCodec._hand, MeshCodec._slot = poisoned_hand, poisoned_slot
    distributed._Lane = SlowLane
    distributed.initialize(init_method=f"file://{store}", world_size=world,
                           rank=rank)
    assert distributed.process_info() == (rank, world)
    d = distributed.DistributedCompressor(backend=GPUCompressor(
        devices=[torch.device("cpu")] * 2, packet_size=64,
        super_batch_packets=2))
    d.compress(f"{tmp}/in.bin", f"{tmp}/out.gip")
    lanes_c = dict(d.lane_seconds)
    d.decompress(f"{tmp}/out.gip", f"{tmp}/back.bin")
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules, "jax imported"
    print(json.dumps({"rank": rank, "poisoned": poisoned, "lanes_c": lanes_c,
                      "lanes_d": d.lane_seconds, "coord": d.coord.total}))
""")


def _run_ranks(tmp_path: Path, script: str, world: int, *args,
               timeout: float = 240) -> list[tuple[int, str]]:
    """Run script as ranks 0..world-1 (FileStore in tmp_path); -> each
    rank's (exit code, output).  Every rank must end within timeout."""
    worker = tmp_path / "worker.py"
    worker.write_text(script)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world),
         str(tmp_path / "store"), str(tmp_path), str(REPO), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


@pytest.mark.parametrize("world", [1, 2, 3])
def test_threaded_worlds_with_poisoned_buffers_write_the_jax_archive(
        tmp_path, world):
    """P = 64, super-batches of 2, both lanes slowed: 2 * 8192 + 321 B is
    262 packets, 131 batches over the ranks' ranges and 131 round-robin
    segments.  Every handed buffer and every reused slot is poisoned, so
    a batch overwritten before its write, or a blob byte the reader did
    not write, would change the archive or the round trip."""
    rng = np.random.default_rng(0x1A4E + world)
    data = rng.integers(0, 256, 2 * P + 321, np.uint8)
    data[1000:9000] = 7
    (tmp_path / "in.bin").write_bytes(data.tobytes())
    results = _run_ranks(tmp_path, _POISON_WORKER, world)
    for rc, out in results:
        assert rc == 0, out[-3000:]
        line = json.loads(out.strip().splitlines()[-1])
        assert line["poisoned"]["handed"] > 0
        assert line["poisoned"]["reused"] > 0
        for lanes in (line["lanes_c"], line["lanes_d"]):
            assert lanes["reader"] > 0 and lanes["writer"] > 0
        assert line["coord"] >= 0
    assert (tmp_path / "out.gip").read_bytes() == \
        _jax_archive(data.tobytes(), 64)
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()


# --- faults on either lane ---------------------------------------------------

class _Faulty:
    """``open`` and ``TemporaryFile`` for the distributed module: the
    ``readinto`` or ``write`` numbered ``at`` (from 1) of the files whose
    names end with ``suffix`` (the spool: ``"spool"``) raises OSError.
    ``opened`` records every file, to check that each was closed."""

    def __init__(self, call: str, suffix: str, at: int):
        self.call, self.suffix, self.at = call, suffix, at
        self.count = 0
        self.opened = []

    def wrap(self, f, name: str):
        faulty = self
        hit = name.endswith(self.suffix)

        class File:
            def readinto(self, b):
                faulty._maybe(hit, "readinto")
                return f.readinto(b)

            def write(self, b):
                faulty._maybe(hit, "write")
                return f.write(b)

            def __getattr__(self, attr):
                return getattr(f, attr)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                f.close()

        self.opened.append(f)
        return File()

    def _maybe(self, hit: bool, call: str) -> None:
        if hit and call == self.call:
            self.count += 1
            if self.count == self.at:
                raise OSError(errno.EIO, f"injected {call} fault")

    def install(self, monkeypatch):
        import tempfile

        real_tmp = tempfile.TemporaryFile
        monkeypatch.setattr(
            distributed, "open",
            lambda path, *a, **kw: self.wrap(open(path, *a, **kw),
                                             str(path)), raising=False)
        monkeypatch.setattr(
            distributed.tempfile, "TemporaryFile",
            lambda *a, **kw: self.wrap(real_tmp(*a, **kw), "spool"))

    def all_closed(self) -> bool:
        return bool(self.opened) and all(f.closed for f in self.opened)


def _multi_batch_case(tmp_path, backend: str):
    """A file of 4 * 8192 + 500 B and the backend that codes it in
    super-batches of 2 (GPUCompressor on two CPU shards at P = 64: 131
    batches; HostCompressor: 3), with its archive."""
    data = np.random.default_rng(0xFA17).integers(0, 256, 4 * P + 500,
                                                  np.uint8)
    data[P: 2 * P] = 9
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    be = GPUCompressor(devices=[CPU, CPU], packet_size=64,
                       super_batch_packets=2) if backend == "gpu" \
        else PortHost(super_batch_packets=2)
    d = distributed.DistributedCompressor(backend=be)
    bounded(d.compress, src, tmp_path / "ok.gip")
    return d, data.tobytes(), src


@pytest.mark.parametrize("backend", ["host", "gpu"])
@pytest.mark.parametrize("fault", [
    ("compress", "readinto", "in.bin", 2),
    ("compress", "write", "spool", 1),
    ("compress", "write", "spool", 2),
    ("decompress", "readinto", "ok.gip", 2),
    ("decompress", "write", "back.bin", 1),
    ("decompress", "write", "back.bin", 2),
], ids=["c-reader", "c-writer-first", "c-writer-second", "d-reader",
        "d-writer-first", "d-writer-second"])
def test_lane_faults_surface_as_raised(tmp_path, monkeypatch,
                                       one_torch_thread, backend, fault):
    """An OSError on the reader (the file's or the archive body's
    readinto) or the writer (the spool's append, the output's write),
    the first or a later one, surfaces from the call as raised; every
    file is closed and no loop thread (reader, writer, walk) is left."""
    verb, call, suffix, at = fault
    d, data, src = _multi_batch_case(tmp_path, backend)
    faulty = _Faulty(call, suffix, at)
    faulty.install(monkeypatch)
    with pytest.raises(OSError, match=f"injected {call} fault"):
        if verb == "compress":
            bounded(d.compress, src, tmp_path / "out.gip")
        else:
            bounded(d.decompress, tmp_path / "ok.gip", tmp_path / "back.bin")
    assert faulty.count == at
    assert faulty.all_closed()
    assert loop_threads() == []
    monkeypatch.undo()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    bounded(d.decompress, tmp_path / "ok.gip", tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data


@pytest.mark.parametrize("backend", ["host", "gpu"])
def test_body_cut_mid_packet_raises_with_no_thread_left(
        tmp_path, monkeypatch, one_torch_thread, backend):
    """An archive cut inside its last packet: the reader's load of the
    last owned segment raises the ContainerError, the writer having
    written the earlier segments; no loop thread is left, and the same
    compressor then decodes the whole archive."""
    d, data, _ = _multi_batch_case(tmp_path, backend)
    whole = (tmp_path / "ok.gip").read_bytes()
    (tmp_path / "cut.gip").write_bytes(whole[:-10])
    with pytest.raises(container.ContainerError,
                       match="truncated packet body"):
        bounded(d.decompress, tmp_path / "cut.gip", tmp_path / "back.bin")
    assert loop_threads() == []
    bounded(d.decompress, tmp_path / "ok.gip", tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data


_FAULT_WORKER = textwrap.dedent("""
    import sys
    rank, world, store, tmp, repo, fault = sys.argv[1:7]
    rank, world = int(rank), int(world)
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(1)
    from gpuar_tpu_torch.parallel import distributed
    from gpuar_tpu_torch.pipeline import HostCompressor

    distributed.initialize(init_method=f"file://{store}", world_size=world,
                           rank=rank)
    d = distributed.DistributedCompressor(
        backend=HostCompressor(super_batch_packets=2))
    if fault == "cut":
        d.decompress(f"{tmp}/cut.gip", f"{tmp}/back.bin")
    else:
        if rank == 1:
            real = distributed._write_at
            def failing(f, offset, data):
                raise OSError(28, "No space left on device")
            distributed._write_at = failing
        d.decompress(f"{tmp}/ok.gip", f"{tmp}/back.bin")
    torch.distributed.destroy_process_group()
""")


@pytest.mark.parametrize("fault", ["cut", "write"])
def test_world2_fault_on_one_rank_ends_every_rank(tmp_path, fault):
    """At world 2, the rank that meets the fault (the body cut in its
    segment, or a failing write on rank 1) raises it as such; its peer
    then fails in a collective instead of waiting for it, and both
    processes end within the timeout."""
    data = np.random.default_rng(0xC07).integers(0, 256, 5 * P + 99,
                                                  np.uint8).tobytes()
    (tmp_path / "in.bin").write_bytes(data)
    PortHost(super_batch_packets=2).compress(tmp_path / "in.bin",
                                             tmp_path / "ok.gip")
    whole = (tmp_path / "ok.gip").read_bytes()
    (tmp_path / "cut.gip").write_bytes(whole[:-10])
    results = _run_ranks(tmp_path, _FAULT_WORKER, 2, fault, timeout=120)
    want = "ContainerError: Incorrect file format: truncated packet body" \
        if fault == "cut" else "OSError: [Errno 28] No space left on device"
    assert all(rc != 0 for rc, _ in results), results
    assert any(want in out for _, out in results), results


# --- the prefetcher and the harness's coordination ---------------------------

def test_prefetcher_close_stops_a_thread_blocked_on_a_full_queue():
    """A loop that ends early closes the prefetcher: a walk blocked on its
    full queue stops, and its thread is joined."""
    produced = []

    def endless():
        while True:
            produced.append(len(produced))
            yield produced[-1]

    segs = distributed._IterPrefetcher(endless(), depth=2)
    assert next(segs) == 0
    segs.close()
    assert not segs._t.is_alive()
    assert loop_threads() == []
    assert len(produced) <= 4


@pytest.mark.parametrize("mode", ["c", "d"])
def test_scaling_coord_is_measured_on_the_sleep_control(tmp_path, mode,
                                                        capsys):
    """World 2 of the sleep control: each rank's coord is the seconds its
    loop spent in collectives, barriers and prefetcher waits (above 0
    and below the wall, never the clamped residual), and the reader's
    and writer's seconds are printed beside it."""
    out = scaling.main(["--backend", "sleep", "--mode", mode, "--worlds",
                        "1,2", "--per-host-mib", "1", "--chip-gbps", "0.5",
                        "--segments-per-host", "4", "--tmpdir",
                        str(tmp_path)])
    two = out["worlds"][1]
    assert 0 < two["coord"] < two["wall"]
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("world=2:")]
    assert len(lines) == 1
    fields = dict(f.split("=") for f in lines[0].split()[1:]
                  if "=" in f)
    assert float(fields["coord"].rstrip("s")) == pytest.approx(
        two["coord"], abs=1e-6)
    assert float(fields["reader"].rstrip("s")) > 0
    assert float(fields["writer"].rstrip("s")) > 0
    assert float(fields["cpu_total"].rstrip("s")) > 0
