"""The port's --multihost layer over torch.distributed (gloo).

Worlds of 2 and 3 processes run DistributedCompressor end to end on the
CPU, joined through a FileStore in the test's directory (no port to pick).
Their archives must equal the JAX package's TPUCompressor archive at
P = 64 and HostCompressor's at 8192 B, and decode back to the input.  The
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

from gpuar_tpu.parallel import distributed as jax_side
from gpuar_tpu.pipeline import HostCompressor
from gpuar_tpu_torch.parallel import distributed
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
