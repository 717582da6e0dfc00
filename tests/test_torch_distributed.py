"""The port's --multihost layer over torch.distributed (gloo).

Worlds of 2 and 3 processes run DistributedCompressor end to end on the
CPU, joined through a FileStore in the test's directory (no port to pick).
Their archives must equal the JAX package's TPUCompressor archive at
P = 64 and HostCompressor's at 8192 B, and decode back to the input.
Worlds of 1, 2 and 3 run it over the backends without the compacted-blob
interface (HostCompressor and the sleep control), which decode through
the fixed-stride segment loader: their archives equal the JAX package's
for the same backend, and an archive with short non-final packets decodes
at its walked raw offsets.  The index walks and segment loaders are held
to the JAX module's at 0 bytes, truncations raising where its do.  The
segment-stream protocol is held to the JAX module's broadcasts, payload by
payload.  The GPU-marked twin runs a world of 2 on one card.
"""

import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from benchmarks.sleep_backend import SleepCompressor as JaxSleep
from gpuar_tpu.parallel import distributed as jax_side
from gpuar_tpu.pipeline import HostCompressor
from gpuar_tpu_torch import container
from gpuar_tpu_torch import native as port_native
from gpuar_tpu_torch.bench.sleep_backend import SleepCompressor
from gpuar_tpu_torch.parallel import distributed
from gpuar_tpu_torch.pipeline import HostCompressor as PortHost
from gpuar_tpu_torch.parallel.runner import GPUCompressor
from test_torch_host import jax_native

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
P = 8192


@pytest.fixture(scope="module", autouse=True)
def _jax_golden():
    """The JAX package's golden codec (an oracle here), loaded first with
    the bounded retry of ``jax_native``."""
    jax_native()

_WORKER = textwrap.dedent("""
    import json, sys
    rank, world, store, tmp, repo, packet, super_batch = sys.argv[1:8]
    rank, world, packet = int(rank), int(world), int(packet)
    sys.path.insert(0, repo)
    import torch
    from gpuar_tpu_torch.ops import _kernels
    from gpuar_tpu_torch.parallel import distributed
    from gpuar_tpu_torch.parallel.runner import GPUCompressor

    distributed.initialize(init_method=f"file://{store}", world_size=world,
                           rank=rank)
    assert distributed.process_info() == (rank, world)
    kw = {} if packet == 8192 else {"packet_size": packet}
    if torch.cuda.is_available():
        backend = GPUCompressor(super_batch_packets=int(super_batch), **kw)
    else:
        backend = GPUCompressor(devices=[torch.device("cpu")],
                                super_batch_packets=int(super_batch), **kw)
    d = distributed.DistributedCompressor(backend=backend)
    d.compress(f"{tmp}/in.bin", f"{tmp}/out.gip")
    d.decompress(f"{tmp}/out.gip", f"{tmp}/back.bin")
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules, "jax imported"
    print(json.dumps({"rank": rank, "launches": _kernels.LAUNCHES}))
""")


def _run_world(tmp_path: Path, world: int, packet: int, super_batch: int):
    """Run the worker on ranks 0..world-1; -> each rank's last JSON line."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world), str(store),
         str(tmp_path), str(REPO), str(packet), str(super_batch)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    lines = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-3000:]
            lines.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return lines


@pytest.mark.parametrize("world", [2, 3])
def test_world_writes_the_jax_archive(tmp_path, world):
    """P = 64, super-batches of 2: 3 * 8192 + 321 B are 4 file-range units
    (ranks get 2, 1, 1 of them at world 3) and 390 packets, decoded in 195
    round-robin segments."""
    from gpuar_tpu.parallel.runner import TPUCompressor

    rng = np.random.default_rng(0xD15 + world)
    data = rng.integers(0, 256, 3 * P + 321, np.uint8)
    data[1000:9000] = 7
    (tmp_path / "in.bin").write_bytes(data.tobytes())
    _run_world(tmp_path, world, 64, 2)
    ref = tmp_path / "jax.gip"
    TPUCompressor(tile=8, packet_size=64).compress(tmp_path / "in.bin", ref)
    assert (tmp_path / "out.gip").read_bytes() == ref.read_bytes()
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()


def test_world2_default_geometry_writes_the_host_archive(tmp_path):
    rng = np.random.default_rng(0xD16)
    data = rng.integers(0, 256, 3 * P + 1234, np.uint8)
    data[P: 2 * P] = 0
    (tmp_path / "in.bin").write_bytes(data.tobytes())
    _run_world(tmp_path, 2, P, 2)
    ref = tmp_path / "host.gip"
    HostCompressor().compress(tmp_path / "in.bin", ref)
    assert (tmp_path / "out.gip").read_bytes() == ref.read_bytes()
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()


_WORKER_STRIDE = textwrap.dedent("""
    import sys
    rank, world, store, tmp, repo, backend = sys.argv[1:7]
    rank, world = int(rank), int(world)
    sys.path.insert(0, repo)
    from gpuar_tpu_torch.parallel import distributed

    distributed.initialize(init_method=f"file://{store}", world_size=world,
                           rank=rank)
    assert distributed.process_info() == (rank, world)
    if backend == "host":
        from gpuar_tpu_torch.pipeline import HostCompressor
        be = HostCompressor(super_batch_packets=2)
    else:
        from gpuar_tpu_torch.bench.sleep_backend import SleepCompressor
        be = SleepCompressor(gbps=50, super_batch_packets=2)
    assert not hasattr(be, "decode_blob_buffer")
    d = distributed.DistributedCompressor(backend=be)
    d.compress(f"{tmp}/in.bin", f"{tmp}/out.gip")
    d.decompress(f"{tmp}/out.gip", f"{tmp}/back.bin")
    d.decompress(f"{tmp}/short.gip", f"{tmp}/short.bin")
    torch_dist = sys.modules["torch.distributed"]
    if torch_dist.is_initialized():
        torch_dist.destroy_process_group()
    assert "jax" not in sys.modules, "jax imported"
""")


def _archive(packets: list[bytes], raw_total: int) -> bytes:
    """A .gip file of back-to-back framed packets."""
    body = b"".join(packets)
    return container.FileHeader(
        uncompressed_size=raw_total,
        compressed_size=container.HEADER_LENGTH + len(body)).to_bytes() + body


def _stored(raw: bytes) -> bytes:
    """One packet as the sleep control frames it: a stored body."""
    return (len(raw) + 4).to_bytes(2, "little") + \
        len(raw).to_bytes(2, "little") + raw


SHORT_SIZES = [100, P, 5000, P, 77, 300]   # short packets mid-file


@pytest.mark.parametrize("backend", ["host", "sleep"])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_stride_backends_round_trip_in_worlds(tmp_path, world, backend):
    """HostCompressor and the sleep control have no blob interface, so
    decode loads each owned segment as a fixed-stride batch.  7 * 8192 +
    1234 B is 8 packets, 4 segments of 2 (ranks own 2, 1, 1 of them at
    world 3).  The archive equals the JAX package's for the same backend,
    and both it and a file of short non-final packets decode back."""
    rng = np.random.default_rng(0xD19 + world)
    data = rng.integers(0, 256, 7 * P + 1234, np.uint8)
    data[2 * P: 4 * P] = 3
    (tmp_path / "in.bin").write_bytes(data.tobytes())
    pieces = [rng.integers(0, 256, n, np.uint8).tobytes() for n in SHORT_SIZES]
    frame = port_native.encode_packet if backend == "host" else _stored
    (tmp_path / "short.gip").write_bytes(
        _archive([frame(x) for x in pieces], sum(SHORT_SIZES)))

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER_STRIDE)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world),
         str(tmp_path / "store"), str(tmp_path), str(REPO), backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    ref = tmp_path / "jax.gip"
    jax_backend = HostCompressor(super_batch_packets=2) if backend == "host" \
        else JaxSleep(gbps=50, super_batch_packets=2)
    jax_backend.compress(tmp_path / "in.bin", ref)
    assert (tmp_path / "out.gip").read_bytes() == ref.read_bytes()
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()
    assert (tmp_path / "short.bin").read_bytes() == b"".join(pieces)


@pytest.mark.parametrize("backend", ["host", "sleep"])
def test_stride_decode_of_a_body_cut_mid_packet(tmp_path, backend,
                                                monkeypatch):
    """The walk finds every header before the cut; the last segment's load
    finds its body short and raises ContainerError."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    be = PortHost(super_batch_packets=2) if backend == "host" else \
        SleepCompressor(gbps=50, super_batch_packets=2)
    data = np.random.default_rng(0xD1A).integers(0, 256, 3 * P + 999,
                                                 np.uint8).tobytes()
    (tmp_path / "in.bin").write_bytes(data)
    d = distributed.DistributedCompressor(backend=be)
    d.compress(tmp_path / "in.bin", tmp_path / "out.gip")
    whole = (tmp_path / "out.gip").read_bytes()
    (tmp_path / "cut.gip").write_bytes(whole[:-500])
    with pytest.raises(container.ContainerError, match="truncated packet"):
        d.decompress(tmp_path / "cut.gip", tmp_path / "back.bin")


def _body_view(module, blob: bytes):
    return module._BodyView(io.BytesIO(blob), 0)


def test_walk_packet_index_equals_jax_and_truncation():
    """The blob of tests/test_distributed.py, an empty body, and a host
    archive's body; truncations raise where the JAX walk raises."""
    bodies = [b"\x11" * 10, b"\x22" * 5, b"\x33" * 100]
    blob = _framed_blob(bodies)
    idx = distributed.walk_packet_index(io.BytesIO(blob), len(blob))
    assert idx.dtype == np.int64
    assert idx[0].tolist() == [0, 14, 23, 127]
    assert idx[1].tolist() == [0, 10, 15, 115]
    data = np.random.default_rng(5).integers(0, 256, 5 * P + 17, np.uint8)
    packets, lengths = port_native.encode_batch(data)
    host_body = b"".join(packets[i, :lengths[i]].tobytes()
                         for i in range(len(lengths)))
    for b in (blob, b"", host_body):
        np.testing.assert_array_equal(
            distributed.walk_packet_index(io.BytesIO(b), len(b)),
            jax_side.walk_packet_index(io.BytesIO(b), len(b)))

    for cut, declared in ((blob[:-1], len(blob) + 3), (blob[:20], len(blob)),
                          (blob, len(blob) - 1), (blob[:2], len(blob))):
        with pytest.raises(Exception) as theirs:
            jax_side.walk_packet_index(io.BytesIO(cut), declared)
        with pytest.raises(container.ContainerError) as ours:
            distributed.walk_packet_index(io.BytesIO(cut), declared)
        assert str(ours.value) == str(theirs.value)


def test_walk_packet_index_chunks_joins_to_the_full_walk():
    bodies = [bytes([i]) * (10 + 7 * i) for i in range(11)]
    blob = _framed_blob(bodies)
    full = distributed.walk_packet_index(io.BytesIO(blob), len(blob))
    for chunk in (1, 2, 3, 11, 100):
        segs = list(distributed.walk_packet_index_chunks(
            io.BytesIO(blob), len(blob), chunk))
        assert all(s.shape[1] - 1 == chunk for s in segs[:-1])
        joined = np.concatenate(
            [segs[0]] + [s[:, 1:] for s in segs[1:]], axis=1)
        np.testing.assert_array_equal(joined, full)


def test_load_segment_equals_jax_and_truncation():
    """Each walked segment of a host archive's body (the last packet
    short) and of hand-framed packets loads to JAX's stride batch byte for
    byte: each packet's header at byte 0 of its row, zeros after it."""
    data = np.random.default_rng(6).integers(0, 256, 6 * P + 1000, np.uint8)
    data[P: 3 * P] = 9
    packets, lengths = port_native.encode_batch(data)
    host_body = b"".join(packets[i, :lengths[i]].tobytes()
                         for i in range(len(lengths)))
    small = _framed_blob([b"\x11" * 10, b"\x22" * 5, b"\x33" * 100])
    for blob in (host_body, small):
        for chunk in (1, 2, 4):
            for seg in distributed.walk_packet_index_chunks(
                    io.BytesIO(blob), len(blob), chunk):
                ours = distributed._load_segment(
                    _body_view(distributed, blob), seg)
                theirs = jax_side._load_segment(
                    _body_view(jax_side, blob), seg)
                assert ours[0].dtype == np.uint8
                assert ours[1].dtype == theirs[1].dtype == np.int32
                np.testing.assert_array_equal(ours[0], theirs[0])
                np.testing.assert_array_equal(ours[1], theirs[1])

    segs = list(distributed.walk_packet_index_chunks(
        io.BytesIO(small), len(small), 2))
    pk, raw = distributed._load_segment(_body_view(distributed, small),
                                        segs[1])
    assert raw.tolist() == [100] and pk[0, 4:104].tobytes() == b"\x33" * 100
    cut = distributed._BodyView(io.BytesIO(small[:-3]), 0)
    with pytest.raises(container.ContainerError, match="truncated packet"):
        distributed._load_segment(cut, segs[1])
    with pytest.raises(jax_side.container.ContainerError,
                       match="truncated packet"):
        jax_side._load_segment(jax_side._BodyView(io.BytesIO(small[:-3]), 0),
                               segs[1])


def test_load_segment_blob_places_the_stride_loaders_packets():
    """tests/test_distributed.py's check on the port, in the dense form:
    the blob loader puts exactly the stride loader's packets at their
    byte offsets, the segment's body as it lies in the file, and raises
    on a body cut mid-packet."""
    bodies = [bytes([i]) * (10 + 7 * i) for i in range(5)]
    blob = _framed_blob(bodies)
    idx = distributed.walk_packet_index(io.BytesIO(blob), len(blob))
    ublob, offsets, clen, raw = distributed._load_segment_blob(
        _body_view(distributed, blob), idx)
    packets, raw2 = distributed._load_segment(_body_view(distributed, blob),
                                              idx)
    np.testing.assert_array_equal(raw, raw2)
    np.testing.assert_array_equal(clen, np.diff(idx[0]).astype(np.int32))
    for i in range(len(bodies)):
        a = int(offsets[i])
        assert ublob[a: a + clen[i]].tobytes() == \
            packets[i, : clen[i]].tobytes(), f"packet {i}"
    assert ublob.tobytes() == blob
    with pytest.raises(container.ContainerError, match="truncated"):
        distributed._load_segment_blob(
            distributed._BodyView(io.BytesIO(blob[:-3]), 0), idx)


def _framed_blob(bodies):
    blob = b""
    for b in bodies:
        total = len(b) + 4
        blob += total.to_bytes(2, "little") + len(b).to_bytes(2, "little") + b
    return blob


@pytest.mark.parametrize("chunk", [1, 2, 3, 23, 50])
def test_segment_stream_matches_the_jax_protocol(chunk, monkeypatch):
    """Rank 0's payloads equal the JAX module's (whose int64 crosses as u32
    halves), and both receivers re-slice them into the same segments."""
    from jax.experimental import multihost_utils

    bodies = [bytes([7 * i % 256]) * (5 + 13 * i % 700) for i in range(23)]
    blob = _framed_blob(bodies)

    def stream(module, rank, body):
        return list(module._segment_stream(
            body, len(blob), rank=rank, world=2, chunk_packets=chunk,
            group_max=4))

    jax_bus, port_bus = [], []
    monkeypatch.setattr(multihost_utils, "broadcast_one_to_all",
                        lambda x: (jax_bus.append(np.array(x)), x)[1])
    monkeypatch.setattr(distributed, "_broadcast",
                        lambda x, group: (port_bus.append(x.copy()), x)[1])
    jax_sent = stream(jax_side, 0, jax_side._BodyView(io.BytesIO(blob), 0))
    port_sent = stream(distributed, 0,
                       distributed._BodyView(io.BytesIO(blob), 0))
    assert len(port_bus) == len(jax_bus) >= 2
    for ours, theirs in zip(port_bus, jax_bus):
        np.testing.assert_array_equal(ours, jax_side._join_u32(theirs))
    assert int(port_bus[-1][0, -1]) == 0

    jax_replay, port_replay = iter(jax_bus), iter(port_bus)
    monkeypatch.setattr(multihost_utils, "broadcast_one_to_all",
                        lambda _x: next(jax_replay))
    monkeypatch.setattr(distributed, "_broadcast",
                        lambda _x, group: next(port_replay))
    jax_got = stream(jax_side, 1, None)
    port_got = stream(distributed, 1, None)
    assert len(port_got) == len(jax_got) == len(port_sent) == \
        len(jax_sent) == -(-23 // chunk)
    for a, b, c in zip(port_got, jax_got, port_sent):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_segment_stream_chunk_mismatch_detected(monkeypatch):
    blob = _framed_blob([b"\x55" * 100] * 6)
    bus = []
    monkeypatch.setattr(distributed, "_broadcast",
                        lambda x, group: (bus.append(x.copy()), x)[1])
    list(distributed._segment_stream(
        distributed._BodyView(io.BytesIO(blob), 0), len(blob), rank=0,
        world=2, chunk_packets=2))
    replay = iter(bus)
    monkeypatch.setattr(distributed, "_broadcast",
                        lambda _x, group: next(replay))
    with pytest.raises(RuntimeError, match="chunk mismatch"):
        list(distributed._segment_stream(None, len(blob), rank=1, world=2,
                                         chunk_packets=3))


def test_world_of_one_without_init_is_the_local_pipeline(tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize()
    assert not dist.is_initialized()
    assert distributed.process_info() == (0, 1)
    data = np.random.default_rng(0xD17).integers(0, 256, 5000,
                                                  np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    backend = GPUCompressor(devices=[CPU, CPU], packet_size=64,
                            super_batch_packets=16)
    d = distributed.DistributedCompressor(backend=backend)
    d.compress(src, tmp_path / "dist.gip")
    backend.compress(src, tmp_path / "local.gip")
    assert (tmp_path / "dist.gip").read_bytes() == \
        (tmp_path / "local.gip").read_bytes()
    d.decompress(tmp_path / "dist.gip", tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data


def test_resume_is_refused(tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(b"abc")
    d = distributed.DistributedCompressor(
        backend=GPUCompressor(devices=[CPU], packet_size=64))
    with pytest.raises(ValueError, match="--resume is not supported"):
        d.compress(src, tmp_path / "o.gip", resume=True)


_CLI = ("import sys; from gpuar_tpu_torch import cli; "
        "rc = cli.main(sys.argv[1:]); "
        "assert 'jax' not in sys.modules, 'jax imported'; sys.exit(rc)")


def _cli(tmp_path, *args, env=None):
    src = tmp_path / "in.bin"
    src.write_bytes(b"hello multihost" * 100)
    return subprocess.run(
        [sys.executable, "-c", _CLI, *args, f"--in={src}",
         f"--out={tmp_path / 'o.gip'}", "--nointeractive"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**{k: v for k, v in os.environ.items()
                if k not in ("WORLD_SIZE", "RANK")}, **(env or {})})


def test_cli_multihost_flags_and_world_errors(tmp_path):
    """--host --multihost is refused; a world of one says so and, without
    CUDA, names --host (importing no JAX); a configured world that cannot
    form exits non-zero and writes nothing."""
    r = _cli(tmp_path, "c", "--multihost", "--host")
    assert r.returncode == 2 and "mutually exclusive" in r.stderr, r.stderr
    r = _cli(tmp_path, "c", "--multihost")
    assert "single process" in r.stderr, r.stderr
    if not torch.cuda.is_available():
        assert r.returncode == 1 and "--host" in r.stderr, r.stderr
    r = _cli(tmp_path, "c", "--multihost", env={"WORLD_SIZE": "2"})
    assert r.returncode == 1, r.stderr
    assert "did not initialise" in r.stderr and "RANK" in r.stderr
    if not torch.cuda.is_available():
        assert not (tmp_path / "o.gip").exists()


@pytest.mark.gpu
def test_gpu_world2_on_the_local_cards(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0xD18)
    data = rng.integers(0, 256, 37 * P + 4321, np.uint8)
    data[10 * P: 20 * P] = 0
    (tmp_path / "in.bin").write_bytes(data.tobytes())
    lines = _run_world(tmp_path, 2, P, 8)
    ref = tmp_path / "host.gip"
    HostCompressor().compress(tmp_path / "in.bin", ref)
    assert (tmp_path / "out.gip").read_bytes() == ref.read_bytes()
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()
    for line in lines:
        assert line["launches"]["encode"] > 0, line
        assert line["launches"]["decode"] > 0, line
