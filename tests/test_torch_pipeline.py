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


def _record_blob_uploads(monkeypatch):
    """Patch DeviceCodec._upload to record each blob it uploads: (is it a
    host tensor, is it pinned)."""
    from gpuar_tpu_torch.parallel.codec import DeviceCodec

    seen, upload = [], DeviceCodec._upload

    def recording(self, slot, name, arr):
        if name == "blob":
            seen.append((isinstance(arr, torch.Tensor),
                         isinstance(arr, torch.Tensor) and arr.is_pinned()))
        return upload(self, slot, name, arr)

    monkeypatch.setattr(DeviceCodec, "_upload", recording)
    return seen


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
    seen = _record_blob_uploads(monkeypatch)
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
    seen = _record_blob_uploads(monkeypatch)
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
