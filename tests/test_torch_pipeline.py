"""The port's main path as a whole: GPUCompressor through the shared
pipeline drive loops, the library entry points and the CLI.

On the CPU, ``GPUCompressor(devices=[torch.device("cpu")])`` runs the
same codec with the kernels' plain versions; its archives must be
byte-identical to the JAX package's (TPUCompressor, Pallas interpret mode)
and to the native host codec's.  The GPU-marked test drives the default
device path.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpuar_tpu.pipeline import HostCompressor
from gpuar_tpu_torch import container
from gpuar_tpu_torch.config import UNCOMPRESSED_PACKET_SIZE as P
from gpuar_tpu_torch.parallel.runner import GPUCompressor
from gpuar_tpu_torch.pipeline import _resume_point
from test_torch_host import jax_native

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _jax_golden():
    """The JAX package's golden codec (an oracle here), loaded first with
    the bounded retry of ``jax_native``."""
    jax_native()


@pytest.fixture
def cuda():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def default_geometry(tmp_path_factory):
    """Three 8192-byte packets plus a ragged tail, and its host archive."""
    tmp = tmp_path_factory.mktemp("default_geometry")
    data = np.random.default_rng(0x51CE).integers(0, 256, 3 * P + 1234,
                                                  np.uint8)
    data[P: 2 * P] = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog. " * 200)[:P],
        np.uint8)
    src = tmp / "in.bin"
    src.write_bytes(data.tobytes())
    ref = tmp / "host.gip"
    HostCompressor().compress(src, ref)
    return src, ref


def test_archive_matches_tpu_compressor_p64(tmp_path, rng):
    """At P = 64 the port writes the JAX package's archive byte for byte."""
    from gpuar_tpu.parallel.runner import TPUCompressor

    data = rng.integers(0, 256, 3000, np.uint8)
    data[1000:1500] = 7
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    TPUCompressor(device_index=0, tile=8, packet_size=64,
                  super_batch_packets=16).compress(src, tmp_path / "tpu.gip")
    port = GPUCompressor(devices=[CPU], packet_size=64,
                         super_batch_packets=16)
    port.compress(src, tmp_path / "port.gip")
    assert (tmp_path / "port.gip").read_bytes() == \
        (tmp_path / "tpu.gip").read_bytes()
    port.decompress(tmp_path / "port.gip", tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()


def test_archive_matches_host_at_default_geometry(tmp_path,
                                                  default_geometry):
    src, ref = default_geometry
    GPUCompressor(devices=[CPU]).compress(src, tmp_path / "port.gip")
    assert (tmp_path / "port.gip").read_bytes() == ref.read_bytes()


def test_host_archive_decodes(tmp_path, default_geometry):
    src, ref = default_geometry
    GPUCompressor(devices=[CPU]).decompress(ref, tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == src.read_bytes()


def test_multi_super_batch_streaming(tmp_path, rng):
    """Several fill/drain rounds give the single-batch archive (P = 64: a
    super-batch of one reads 8192 bytes, 128 packets)."""
    data = rng.integers(0, 256, 3 * P + 321, np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    small, big = tmp_path / "small.gip", tmp_path / "big.gip"
    GPUCompressor(devices=[CPU], packet_size=64,
                  super_batch_packets=1).compress(src, small)
    GPUCompressor(devices=[CPU], packet_size=64,
                  super_batch_packets=16).compress(src, big)
    assert small.read_bytes() == big.read_bytes()
    GPUCompressor(devices=[CPU], packet_size=64,
                  super_batch_packets=3).decompress(small, tmp_path / "b")
    assert (tmp_path / "b").read_bytes() == data


def test_resume_interrupted_compression(tmp_path, default_geometry):
    src, ref = default_geometry
    blob = ref.read_bytes()
    for cut in ("mid_packet", "packet_boundary"):
        part = tmp_path / f"{cut}.gip"
        if cut == "mid_packet":
            part.write_bytes(blob[: len(blob) * 2 // 3])
        else:
            _, done_comp, _ = _resume_point(ref)
            part.write_bytes(blob[: container.HEADER_LENGTH + done_comp])
        info = GPUCompressor(devices=[CPU]).compress(src, part, resume=True)
        assert part.read_bytes() == blob, cut
        assert info.compressed_file_size == len(blob)


def test_debug_decompress_flags_corrupt_packet(tmp_path, rng):
    data = np.zeros(64 * 6, np.uint8)
    data[:64] = rng.integers(0, 256, 64, np.uint8)
    src, gip = tmp_path / "in.bin", tmp_path / "in.gip"
    src.write_bytes(data.tobytes())
    GPUCompressor(devices=[CPU], packet_size=64).compress(src, gip)
    debug = GPUCompressor(devices=[CPU], packet_size=64, debug=True)
    debug.decompress(gip, tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()

    raw = bytearray(gip.read_bytes())
    first = container.HEADER_LENGTH
    second = first + (raw[first] | raw[first + 1] << 8)
    total = raw[second] | raw[second + 1] << 8
    raw[second + 4: second + total] = rng.integers(
        0, 256, total - 4, np.uint8).tobytes()
    bad = tmp_path / "bad.gip"
    bad.write_bytes(bytes(raw))
    with pytest.raises(container.ContainerError, match=r"packets \[1\]"):
        debug.decompress(bad, tmp_path / "out.bin")


def test_gpu_compressor_needs_cuda_by_default():
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="no device"):
            GPUCompressor(device_index=torch.cuda.device_count())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GPUCompressor()


def test_library_entry_points(tmp_path, rng):
    import gpuar_tpu_torch

    data = rng.integers(0, 256, 5000, np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    gpuar_tpu_torch.compress(src, tmp_path / "h.gip", host=True)
    assert gpuar_tpu_torch.verify(tmp_path / "h.gip", deep=True)["valid"]
    gpuar_tpu_torch.decompress(tmp_path / "h.gip", tmp_path / "back.bin",
                               host=True)
    assert (tmp_path / "back.bin").read_bytes() == data
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            gpuar_tpu_torch.compress(src, tmp_path / "g.gip")


def test_port_imports_no_jax():
    code = ("import sys, gpuar_tpu_torch, gpuar_tpu_torch.cli, "
            "gpuar_tpu_torch.parallel.runner, gpuar_tpu_torch.ops.decode, "
            "gpuar_tpu_torch.parallel.mesh, "
            "gpuar_tpu_torch.parallel.distributed; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "gpuar_tpu_torch.cli", *args,
         "--nointeractive"],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_host_round_trip(tmp_path, rng):
    data = rng.integers(0, 256, 2 * P + 99, np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    gip, back = tmp_path / "o.gip", tmp_path / "back.bin"
    r = _cli("c", f"--in={src}", f"--out={gip}", "--host")
    assert r.returncode == 0, r.stderr
    r = _cli("d", f"--in={gip}", f"--out={back}", "--host")
    assert r.returncode == 0, r.stderr
    assert back.read_bytes() == data
    ref = tmp_path / "ref.gip"
    HostCompressor().compress(src, ref)
    assert gip.read_bytes() == ref.read_bytes()


def test_cli_refuses_without_cuda_or_bad_flags(tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(b"hello")
    for bad in (["c", "--multihost", "--host"], ["d", "--debug", "--host"],
                ["c", "--debug"]):
        r = _cli(*bad, f"--in={src}", f"--out={tmp_path / 'x'}")
        assert r.returncode == 2, (bad, r.stderr)
    if torch.cuda.is_available():
        return
    r = _cli("c", f"--in={src}", f"--out={tmp_path / 'x.gip'}")
    assert r.returncode != 0
    assert "--host" in r.stderr
    assert not (tmp_path / "x.gip").exists()


@pytest.mark.gpu
def test_gpu_main_path_matches_host(cuda, tmp_path):
    from gpuar_tpu_torch.ops import _kernels

    data = np.random.default_rng(3).integers(0, 256, 5 * P + 777, np.uint8)
    data[2 * P: 4 * P] = 0
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    ref = tmp_path / "host.gip"
    HostCompressor().compress(src, ref)
    _kernels.reset_counts()
    gpu = GPUCompressor(super_batch_packets=2)
    gpu.compress(src, tmp_path / "gpu.gip")
    assert (tmp_path / "gpu.gip").read_bytes() == ref.read_bytes()
    gpu.decompress(ref, tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()
    GPUCompressor(debug=True).decompress(ref, tmp_path / "back2.bin")
    assert (tmp_path / "back2.bin").read_bytes() == data.tobytes()
    assert min(_kernels.LAUNCHES.values()) > 0


def _record_uploads(monkeypatch, name: str = "blob", keep=None):
    """Patch DeviceCodec._upload to record each upload of ``name`` ("blob"
    for decode, "data" for encode): (is it a host tensor, is it pinned);
    with a list ``keep``, also a copy of each upload's bytes."""
    from gpuar_tpu_torch.parallel.codec import DeviceCodec

    seen, upload = [], DeviceCodec._upload

    def recording(self, slot, what, arr):
        if what == name:
            seen.append((isinstance(arr, torch.Tensor),
                         isinstance(arr, torch.Tensor) and arr.is_pinned()))
            if keep is not None:
                keep.append(np.array(arr, copy=True))
        return upload(self, slot, what, arr)

    monkeypatch.setattr(DeviceCodec, "_upload", recording)
    return seen


def _fill_handed_buffers(monkeypatch):
    """Fill every buffer MeshCodec.encode_buffer hands out with 0xFF, so a
    ragged tail the drive loop did not zero would show in the archive."""
    from gpuar_tpu_torch.parallel.mesh import MeshCodec

    hand = MeshCodec.encode_buffer

    def filled(self, n):
        buf = hand(self, n)
        buf.fill(0xFF)
        return buf

    monkeypatch.setattr(MeshCodec, "encode_buffer", filled)


def _three_batch_file(tmp_path):
    """Five packets, two of text and the last ragged, and their host
    archive: three super-batches of up to two packets."""
    data = np.random.default_rng(0x4057).integers(0, 256, 4 * P + 999,
                                                  np.uint8)
    data[P: 3 * P] = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog. " * 400)[: 2 * P],
        np.uint8)
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    ref = tmp_path / "host.gip"
    HostCompressor().compress(src, ref)
    return data.tobytes(), src, ref


def test_decompress_builds_blob_in_upload_buffer(tmp_path, monkeypatch):
    """Over three super-batches, GPUCompressor on two CPU shards writes the
    host archive and decodes it to the host's output; every shard's blob
    is uploaded from the slot's buffer the reader built it in, not
    copied."""
    from gpuar_tpu_torch.pipeline import HostCompressor as PortHost

    data, src, ref = _three_batch_file(tmp_path)
    gpu = GPUCompressor(devices=[CPU, CPU], super_batch_packets=2)
    gpu.compress(src, tmp_path / "gpu.gip")
    assert (tmp_path / "gpu.gip").read_bytes() == ref.read_bytes()
    seen = _record_uploads(monkeypatch)
    gpu.decompress(ref, tmp_path / "back.bin")
    PortHost(super_batch_packets=2).decompress(ref, tmp_path / "host.bin")
    assert (tmp_path / "back.bin").read_bytes() == data
    assert (tmp_path / "host.bin").read_bytes() == data
    assert seen == [(True, False)] * 5   # 2 + 2 + 1 packets


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_gpu_decompress_uploads_pinned_blob(cuda, tmp_path, monkeypatch,
                                            shards):
    """On the card, over three super-batches, decompress round-trips and
    each shard uploads a pinned tensor (two shards share the one card)."""
    data, src, ref = _three_batch_file(tmp_path)
    seen = _record_uploads(monkeypatch)
    GPUCompressor(devices=[cuda] * shards, super_batch_packets=2) \
        .decompress(ref, tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data
    assert seen == [(True, True)] * (1 + 2 * shards)


def test_compacted_body_path_matches_stride_path(rng):
    """DeviceCodec's compacted encode (device row gather + splice_at) gives
    exactly the stride path's spliced bytes, and the stride decode and the
    reader-built blob decode both round-trip them."""
    from gpuar_tpu_torch.parallel.codec import BUCKET_ROWS, DeviceCodec
    from gpuar_tpu_torch.pipeline import _PacketReader

    codec = DeviceCodec(CPU, packet_size=64)
    n = 70
    data = rng.integers(0, 256, (n, 64), np.uint8)
    sizes = np.full(n, 64, np.int32)
    sizes[3], sizes[-1] = 9, 0
    data[3, 9:] = 0
    data[-1] = 0
    data[10:30] = 7
    packets, lengths = codec.encode(data, sizes)
    expected = b"".join(packets[i, : lengths[i]].tobytes() for i in range(n))
    body, lengths2 = codec.encode_body_wait(
        codec.encode_body_async(data, sizes))
    np.testing.assert_array_equal(lengths2, lengths)
    assert body.tobytes() == expected

    np.testing.assert_array_equal(codec.decode(packets, sizes), data)
    reader = _PacketReader(io.BytesIO(expected), max_raw=64)
    blob, roff, comp_len, raw = reader.read_batch_blob(n, codec.row_bytes,
                                                       BUCKET_ROWS)
    out = codec.decode_body_wait(
        codec.decode_blob_async(blob, roff, comp_len, raw))
    np.testing.assert_array_equal(out, data)


# --- the compress feed: the file read straight into the upload buffer ------

def _jax_archive(data: bytes, packet_size: int) -> bytes:
    """The JAX package's archive of data at packet_size: its golden
    codec's stream body behind its file header."""
    from gpuar_tpu import container as jax_container

    body = jax_native().encode_stream(data, packet_size)
    return jax_container.FileHeader(
        uncompressed_size=len(data),
        compressed_size=jax_container.HEADER_LENGTH + len(body)).to_bytes() \
        + body


def _p64_file(tmp_path):
    """2 * 8192 + 3000 B at P = 64: three super-batches of one (128, 128
    and 47 packets, the last ragged), text in the second."""
    data = np.random.default_rng(0xFEED).integers(0, 256, 2 * P + 3000,
                                                  np.uint8)
    data[P: 2 * P] = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog. " * 200)[:P],
        np.uint8)
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    return data.tobytes(), src


@pytest.mark.parametrize("k", [1, 2, 3])
def test_compress_reads_into_upload_buffer(tmp_path, monkeypatch, k):
    """On k CPU shards, over three super-batches with a ragged last packet
    and every handed buffer filled with 0xFF first, the archive equals
    the JAX package's at 0 bytes; each shard of each batch uploads its
    rows of the buffer the file was read into (a host tensor: no copy),
    and the rows uploaded, in order, are the file zero-padded to whole
    packets (none of the 0xFF is left in the ragged tail)."""
    data, src = _p64_file(tmp_path)
    _fill_handed_buffers(monkeypatch)
    rows = []
    seen = _record_uploads(monkeypatch, "data", keep=rows)
    gpu = GPUCompressor(devices=[CPU] * k, packet_size=64,
                        super_batch_packets=1)
    gpu.compress(src, tmp_path / "port.gip")
    assert (tmp_path / "port.gip").read_bytes() == _jax_archive(data, 64)
    assert seen == [(True, False)] * (3 * k)
    padded = np.zeros(-(-len(data) // 64) * 64, np.uint8)
    padded[: len(data)] = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(np.concatenate(rows).reshape(-1), padded)
    gpu.decompress(tmp_path / "port.gip", tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data


@pytest.mark.parametrize("resume", [False, True])
def test_default_geometry_feed_matches_host(tmp_path, monkeypatch, resume):
    """At 8192 B on [cpu] * 3, with 0xFF-filled buffers: three
    super-batches of two (2 + 2 + 1 packets, the last ragged) give
    HostCompressor's archive; resumed from an archive cut inside its third
    packet, the three packets left go in three super-batches of one and
    give it too."""
    data, src, ref = _three_batch_file(tmp_path)
    blob = ref.read_bytes()
    out = tmp_path / "port.gip"
    sbp = 2
    if resume:
        at = container.HEADER_LENGTH
        for _ in range(2):
            at += blob[at] | blob[at + 1] << 8
        out.write_bytes(blob[: at + 100])
        sbp = 1
    _fill_handed_buffers(monkeypatch)
    rows = []
    seen = _record_uploads(monkeypatch, "data", keep=rows)
    info = GPUCompressor(devices=[CPU] * 3, super_batch_packets=sbp) \
        .compress(src, out, resume=resume)
    assert out.read_bytes() == blob
    assert info.compressed_file_size == len(blob)
    assert seen == [(True, False)] * (3 if resume else 5)
    padded = np.zeros(5 * P, np.uint8)
    padded[: len(data)] = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(np.concatenate(rows).reshape(-1),
                                  padded[2 * P if resume else 0:])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fetched_body_survives_next_submit(k):
    """In the drive loop's order (submit N + 1, fetch N, submit N + 2,
    write N), batch N's body, spliced in place in its slot's buffer and
    not in a fresh array, is still intact after batch N + 2 was read into
    and submitted from the same slot's data buffer."""
    from gpuar_tpu_torch.parallel.mesh import MeshCodec

    rng = np.random.default_rng(0xB0D1 + k)
    batches = [rng.integers(0, 256, n, np.uint8) for n in (P, P, 3000)]
    batches[1][:4000] = 7
    gpu = GPUCompressor(devices=[CPU] * k, packet_size=64,
                        super_batch_packets=1)

    def submit(raw):
        buf = MeshCodec.encode_buffer(gpu.codec, -(-raw.size // 64))
        buf.fill(0xFF)
        flat = gpu.encode_buffer(raw.size)
        flat[: raw.size] = raw
        return gpu.encode_submit(flat[: raw.size])

    want = [jax_native().encode_stream(b.tobytes(), 64) for b in batches]
    h0, h1 = submit(batches[0]), submit(batches[1])
    body0, _ = gpu.encode_fetch(h0)
    assert body0.ctypes.data == gpu.codec._slots[0].bufs["blob"].data_ptr()
    h2 = submit(batches[2])
    assert body0.tobytes() == want[0]
    body1, _ = gpu.encode_fetch(h1)
    assert body1.tobytes() == want[1]
    assert body0.tobytes() == want[0]
    body2, _ = gpu.encode_fetch(h2)
    assert body2.tobytes() == want[2]
    assert body1.tobytes() == want[1]


@pytest.mark.parametrize("k", [1, 3])
def test_array_from_elsewhere_goes_through_the_copy(monkeypatch, k):
    """encode_batch of a read-only array that was not read into the
    handed buffer (one handed and filled with 0xFF, then left unused)
    gives the JAX package's body: it is copied into the slot's data
    buffer, whose ragged tail is zeroed, and the shards upload that."""
    rng = np.random.default_rng(0xC0DE)
    raw = np.frombuffer(rng.integers(0, 256, 5000, np.uint8).tobytes(),
                        np.uint8)
    gpu = GPUCompressor(devices=[CPU] * k, packet_size=64)
    gpu.encode_buffer(P).fill(0xFF)
    rows = []
    seen = _record_uploads(monkeypatch, "data", keep=rows)
    body, lengths = gpu.encode_batch(raw)
    assert body.tobytes() == jax_native().encode_stream(raw.tobytes(), 64)
    assert lengths.shape == (79,)
    assert seen == [(True, False)] * k
    padded = np.zeros(79 * 64, np.uint8)
    padded[: raw.size] = raw
    np.testing.assert_array_equal(np.concatenate(rows).reshape(-1), padded)


_WORLD_WORKER = """
import sys
rank, world, store, src, dst, repo, shards = sys.argv[1:8]
sys.path.insert(0, repo)
import torch
from gpuar_tpu_torch.parallel import distributed
from gpuar_tpu_torch.parallel.mesh import MeshCodec
from gpuar_tpu_torch.parallel.runner import GPUCompressor

hand = MeshCodec.encode_buffer


def filled(self, n):
    buf = hand(self, n)
    buf.fill(0xFF)
    return buf


MeshCodec.encode_buffer = filled
distributed.initialize(init_method=f"file://{store}", world_size=int(world),
                       rank=int(rank))
distributed.DistributedCompressor(backend=GPUCompressor(
    devices=[torch.device("cpu")] * int(shards), packet_size=64,
    super_batch_packets=1)).compress(src, dst)
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("world,shards", [(1, 3), (2, 2)])
def test_multihost_compress_reads_into_upload_buffer(tmp_path, world,
                                                     shards):
    """DistributedCompressor in worlds of 1 and 2 processes (FileStore in
    tmp_path) over GPUCompressor on CPU shards, with 0xFF-filled handed
    buffers: the archive equals the JAX package's at 0 bytes (rank 0
    reads two super-batches, rank 1 one and a ragged one)."""
    data = np.random.default_rng(0x3D).integers(0, 256, 3 * P + 777,
                                                np.uint8)
    data[P: 2 * P] = 3
    src, dst = tmp_path / "in.bin", tmp_path / "out.gip"
    src.write_bytes(data.tobytes())
    worker = tmp_path / "worker.py"
    worker.write_text(_WORLD_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world),
         str(tmp_path / "store"), str(src), str(dst), str(REPO),
         str(shards)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert dst.read_bytes() == _jax_archive(data.tobytes(), 64)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_gpu_compress_uploads_pinned_data(cuda, tmp_path, monkeypatch,
                                          shards):
    """On the card, over three super-batches with 0xFF-filled handed
    buffers, the archive equals the host's, and every data upload of the
    file compress is a pinned host tensor (two shards share the card)."""
    data, src, ref = _three_batch_file(tmp_path)
    _fill_handed_buffers(monkeypatch)
    seen = _record_uploads(monkeypatch, "data")
    GPUCompressor(devices=[cuda] * shards, super_batch_packets=2) \
        .compress(src, tmp_path / "gpu.gip")
    assert (tmp_path / "gpu.gip").read_bytes() == ref.read_bytes()
    assert seen == [(True, True)] * (1 + 2 * shards)
