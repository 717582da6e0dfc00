"""The GPU path's super-batch, sized from the card.

``runner.batch_packets`` turns a card's launch geometry (SMs, blocks of
the codec kernels an SM holds, threads a block) into a batch of
``ceil(f x SMs)`` blocks of one packet a thread; ``GPUCompressor()``
takes it per card, times the number of devices.  On the CPU the geometry
is faked (``runner.launch_geometry`` patched): the sizes of the H100's
132 SMs, 2 blocks and 64 threads; k shards; CPU devices, the host codec,
the sleep control and an explicit size keep theirs.  At rule-sized
batches on CPU shards (64-byte packets) the archive equals the JAX
package's host codec's for files of 1, 2 and 3 batches, and two gloo
ranks with other fake SM counts adopt rank 0's size and write a world of
one's archive.  The GPU-marked tests read the card's own geometry and
write the host archive of a 160 MiB file at its batch.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from gpuar_tpu_torch import cli
from gpuar_tpu_torch.bench.sleep_backend import SleepCompressor
from gpuar_tpu_torch.parallel import runner
from gpuar_tpu_torch.pipeline import DEFAULT_SUPER_BATCH_PACKETS, \
    HostCompressor
from test_torch_host import jax_native
from test_torch_pipeline import one_torch_thread  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
H100 = (132, 2, 64)   # SMs, blocks an SM, threads a block
P = 64


def fake_card(monkeypatch, geometry=H100):
    """Every device reads as a card of ``geometry`` (a tuple, or a list
    taken one a device)."""
    it = iter(geometry) if isinstance(geometry, list) else None
    monkeypatch.setattr(runner, "launch_geometry",
                        lambda device: next(it) if it else geometry)


@pytest.mark.parametrize("f, packets", [(1 / 8, 1088), (1 / 4, 2112),
                                        (1 / 2, 4224), (1, 8448),
                                        (2, 16896), (4, 33792)])
def test_rule_gives_each_f_its_size(f, packets):
    """ceil(f x 132) blocks of 64 packets: f blocks an SM is f / 2 waves
    of the 2 blocks an SM holds."""
    assert runner.batch_packets(H100, f / H100[1]) == packets


@pytest.mark.parametrize("k", [1, 2, 3])
def test_k_cards_give_k_times_the_size(monkeypatch, k):
    fake_card(monkeypatch)
    gpu = runner.GPUCompressor(devices=[CPU] * k)
    assert gpu.super_batch_packets == k * runner.batch_packets(H100)
    assert gpu.batch_from_card


def test_cards_that_differ_take_the_least(monkeypatch):
    fake_card(monkeypatch, [H100, (114, 2, 64), H100])
    gpu = runner.GPUCompressor(devices=[CPU] * 3)
    assert gpu.super_batch_packets == 3 * runner.batch_packets((114, 2, 64))


@pytest.mark.parametrize("make", [
    lambda: runner.GPUCompressor(devices=[CPU]),
    lambda: runner.GPUCompressor(devices=[CPU, CPU], packet_size=P),
    lambda: HostCompressor(),
    lambda: SleepCompressor(gbps=1.0),
], ids=["gpu_on_cpu", "gpu_on_two_cpu_shards", "host", "sleep"])
def test_cpu_host_and_sleep_keep_8192(make):
    backend = make()
    assert backend.super_batch_packets == DEFAULT_SUPER_BATCH_PACKETS == 8192
    assert not getattr(backend, "batch_from_card", False)


@pytest.mark.parametrize("argv, want", [
    ([], None), (["--batch-packets=7"], 7)], ids=["default", "explicit"])
def test_cli_batch_packets_overrides_the_card(monkeypatch, argv, want):
    """The CLI's GPU backend on a faked card: the card's size, or
    ``--batch-packets``'s."""
    fake_card(monkeypatch)
    real = runner.GPUCompressor
    monkeypatch.setattr(runner, "GPUCompressor",
                        lambda **kw: real(devices=[CPU], **kw))
    args = cli.build_parser().parse_args(["c", "--in=x", "--out=y", *argv])
    gpu = cli.make_compressor(args)
    assert gpu.super_batch_packets == (want or runner.batch_packets(H100))
    assert gpu.batch_from_card == (want is None)


def test_explicit_size_wins_over_the_card(monkeypatch):
    fake_card(monkeypatch)
    gpu = runner.GPUCompressor(devices=[CPU], super_batch_packets=5)
    assert gpu.super_batch_packets == 5 and not gpu.batch_from_card


def jax_host_archive(data: bytes) -> bytes:
    """The JAX package's host codec's archive of data at P-byte packets:
    its FileHeader and its native encode_stream body."""
    from gpuar_tpu import container

    body = jax_native().encode_stream(data, packet_size=P)
    return container.FileHeader(
        uncompressed_size=len(data),
        compressed_size=container.HEADER_LENGTH + len(body)).to_bytes() \
        + body


@pytest.mark.parametrize("batches", [1, 2, 3])
@pytest.mark.parametrize("tail", [-100, 321], ids=["short", "over"])
def test_rule_sized_batches_write_the_jax_host_archive(
        tmp_path, monkeypatch, one_torch_thread, batches, tail):
    """Two CPU shards of a small fake card: the file is ``batches``
    rule-sized super-batches, 100 B short of the last one's end (its last
    packet ragged) or 321 B over it (one more batch, ragged).  The archive
    equals the JAX package's; decoding gives the file back."""
    fake_card(monkeypatch, (3, 2, 1))
    gpu = runner.GPUCompressor(devices=[CPU] * 2, packet_size=P)
    assert gpu.batch_from_card
    batch_bytes = gpu.super_batch_packets * 8192   # what the loop reads
    rng = np.random.default_rng(0x1A0 + batches)
    data = rng.integers(0, 256, batches * batch_bytes + tail, np.uint8)
    data[: batch_bytes // 2] = 9
    src, gip, back = tmp_path / "in.bin", tmp_path / "c.gip", \
        tmp_path / "back.bin"
    src.write_bytes(data.tobytes())
    gpu.compress(src, gip)
    assert gip.read_bytes() == jax_host_archive(data.tobytes())
    runner.GPUCompressor(devices=[CPU] * 2, packet_size=P,
                         super_batch_packets=1 << 14).decompress(gip, back)
    assert back.read_bytes() == data.tobytes()


_WORKER = textwrap.dedent("""
    import json, sys
    rank, world, store, tmp, repo = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(1)
    from gpuar_tpu_torch.parallel import distributed, runner

    # A card of another SM count on each rank.
    sms = 4 if rank == 0 else 12
    runner.launch_geometry = lambda device: (sms, 2, 8)
    distributed.initialize(init_method=f"file://{store}", world_size=world,
                           rank=rank)
    backend = runner.GPUCompressor(devices=[torch.device("cpu")],
                                   packet_size=64)
    own = backend.super_batch_packets
    d = distributed.DistributedCompressor(backend=backend)
    d.compress(f"{tmp}/in.bin", f"{tmp}/out.gip")
    d.decompress(f"{tmp}/out.gip", f"{tmp}/back.bin")
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules, "jax imported"
    print(json.dumps({"rank": rank, "own": own,
                      "used": backend.super_batch_packets}))
""")


def test_ranks_adopt_rank_0s_size(tmp_path):
    """A world of 2 over gloo whose ranks' fake cards size other batches
    (4 and 12 SMs): both use rank 0's, and the archive equals a world of
    one's (GPUCompressor on one CPU device) and decodes back."""
    rng = np.random.default_rng(0xB47)
    data = rng.integers(0, 256, 40_000, np.uint8)
    data[5000:15000] = 3
    (tmp_path / "in.bin").write_bytes(data.tobytes())
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), "2", str(tmp_path / "store"),
         str(tmp_path), str(REPO)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
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
    rank0 = runner.batch_packets((4, 2, 8))
    assert [x["own"] for x in lines] == [rank0,
                                         runner.batch_packets((12, 2, 8))]
    assert lines[0]["own"] != lines[1]["own"]
    assert [x["used"] for x in lines] == [rank0, rank0]
    one = tmp_path / "one.gip"
    runner.GPUCompressor(devices=[CPU], packet_size=P).compress(
        tmp_path / "in.bin", one)
    assert (tmp_path / "out.gip").read_bytes() == one.read_bytes()
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()


@pytest.mark.gpu
def test_gpu_default_batch_from_the_card():
    """On the card: the geometry's SMs are the device's, its blocks an SM
    the runtime's occupancy of the codec kernels (at least one), and
    GPUCompressor() takes the rule's size per card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda", 0)
    sms, blocks, threads = runner.launch_geometry(cuda)
    assert sms == torch.cuda.get_device_properties(cuda) \
        .multi_processor_count
    assert blocks >= 1 and threads == 64
    gpu = runner.GPUCompressor()
    assert gpu.batch_from_card
    assert gpu.super_batch_packets == torch.cuda.device_count() \
        * runner.batch_packets((sms, blocks, threads))


@pytest.mark.gpu
def test_gpu_default_writes_the_host_archive(tmp_path):
    """GPUCompressor() on the card over 160 MiB + 4321 B of random bytes,
    text and zeros (five of its batches on the H100, the last ragged):
    the archive equals HostCompressor's and decompress returns the
    file's md5."""
    import hashlib

    from gpuar_tpu_torch.bench import corpora

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0x5C11)
    mib = 1 << 20
    src, gip, host, back = (tmp_path / n for n in (
        "in.bin", "gpu.gip", "host.gip", "back.bin"))
    with open(src, "wb") as f:
        f.write(rng.integers(0, 256, 64 * mib, np.uint8).tobytes())
        f.write(corpora.generate(48 * mib))
        f.write(bytes(48 * mib))
        f.write(rng.integers(0, 256, 4321, np.uint8).tobytes())
    HostCompressor(threads=0).compress(src, host)
    gpu = runner.GPUCompressor()
    assert gpu.batch_from_card
    gpu.compress(src, gip)
    gpu.decompress(gip, back)
    assert gip.read_bytes() == host.read_bytes()

    def md5(path):
        with open(path, "rb") as f:
            return hashlib.file_digest(f, "md5").hexdigest()
    assert md5(back) == md5(src)
