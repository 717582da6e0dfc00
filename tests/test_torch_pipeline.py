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
import time
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


def test_decompress_submits_the_handed_buffer_read_by_readinto(
        tmp_path, monkeypatch, one_torch_thread):
    """The dense feed on one CPU device, three batches of 2048 packets at
    P = 64 (the JAX package's archive): each blob decode_submit_blob gets
    is the head of the buffer decode_blob_buffer handed out (filled with
    0xFF first), that buffer was filled by the file's readinto, every
    packet walk was the header walk (no destination: no packet byte
    copied), and the round trip is exact."""
    from gpuar_tpu_torch import native, pipeline

    rng = np.random.default_rng(0xDE45)
    data = rng.integers(0, 256, 3 * 2048 * 64 - 1000, np.uint8)
    data[: 64 * 500] = 9
    gip = tmp_path / "jax.gip"
    gip.write_bytes(_jax_archive(data.tobytes(), 64))
    gpu = GPUCompressor(devices=[CPU], packet_size=64,
                        super_batch_packets=2048)
    handed, submitted, reads, walks = [], [], [], []
    hand, submit = GPUCompressor.decode_blob_buffer, \
        GPUCompressor.decode_submit_blob
    walk, real_open = native.walk_packets, open

    def handing(self, nbytes):
        buf = hand(self, nbytes)
        buf.fill(0xFF)
        handed.append(buf)
        return buf

    def submitting(self, blob, *rest):
        submitted.append((blob, len(handed)))
        return submit(self, blob, *rest)

    def walking(buf, start, end, max_packets, max_raw, dst, *rest, **kw):
        walks.append(dst is None)
        return walk(buf, start, end, max_packets, max_raw, dst, *rest, **kw)

    class Reading:
        def __init__(self, f):
            self._f = f

        def readinto(self, b):
            reads.append(np.frombuffer(b, np.uint8).ctypes.data)
            return self._f.readinto(b)

        def __getattr__(self, name):
            return getattr(self._f, name)

    monkeypatch.setattr(GPUCompressor, "decode_blob_buffer", handing)
    monkeypatch.setattr(GPUCompressor, "decode_submit_blob", submitting)
    monkeypatch.setattr(native, "walk_packets", walking)
    monkeypatch.setattr(pipeline, "open",
                        lambda *a, **kw: Reading(real_open(*a, **kw)),
                        raising=False)
    gpu.decompress(gip, tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()
    assert len(submitted) == 3 and walks and all(walks)
    for blob, k in submitted:
        buf = handed[k - 1]
        assert blob.ctypes.data == buf.ctypes.data
        assert np.shares_memory(blob, buf)
        lo, hi = buf.ctypes.data, buf.ctypes.data + buf.size
        assert any(lo <= at < hi for at in reads), "no read into the blob"


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("case", ["p64", "last packet 256 B"])
def test_dense_decompress_of_jax_archives(tmp_path, one_torch_thread, case,
                                          shards):
    """GPUCompressor on one CPU device and a MeshCodec of two decompress
    the JAX package's archives bit for bit through the dense feed: at
    P = 64 in batches of 100 packets, and at 8192 B in batches of three
    with a last packet of 256 B."""
    rng = np.random.default_rng(0xDE46)
    if case == "p64":
        packet, batch = 64, 100
        data = rng.integers(0, 256, 777 * 64 + 13, np.uint8)
        data[64 * 200: 64 * 400] = 3
    else:
        packet, batch = P, 3
        data = rng.integers(0, 256, 7 * P + 256, np.uint8)
        data[P: 3 * P] = 0
    gip = tmp_path / "jax.gip"
    gip.write_bytes(_jax_archive(data.tobytes(), packet))
    GPUCompressor(devices=[CPU] * shards, packet_size=packet,
                  super_batch_packets=batch).decompress(
        gip, tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == data.tobytes()


def test_compacted_body_path_matches_stride_path(rng):
    """DeviceCodec's body encode (K1, then G1's gather of the body on the
    device, nothing spliced on the host) gives exactly the stride path's
    spliced bytes, and the stride decode and the reader's dense blob
    decode both round-trip them."""
    from gpuar_tpu_torch.parallel.codec import DeviceCodec
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
    blob, offsets, comp_len, raw = reader.read_batch_dense(n)
    out = codec.decode_body_wait(
        codec.decode_blob_async(blob, offsets, comp_len, raw))
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
    write N), batch N's body, downloaded as it lies in the file into its
    slot's buffer and not into a fresh array, is still intact after batch N + 2 was read into
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


# --- the drive loops on three threads ----------------------------------------

def loop_threads() -> list:
    """The drive loops' reader and writer threads still alive."""
    import threading

    return [t for t in threading.enumerate() if t.name.startswith("gpuar-")]


def bounded(fn, *args, timeout: float = 120.0, **kw):
    """fn(*args, **kw) on a thread of its own, joined with a timeout: its
    result, or its exception raised again; a call that outlives the
    timeout fails the test rather than hanging it."""
    import threading

    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as err:   # raised again below
            out["err"] = err

    t = threading.Thread(target=run, name="test-call", daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} did not end within {timeout} s"
    if "err" in out:
        raise out["err"]
    return out["value"]


class SlowFiles:
    """``open`` for the pipeline module: each file's readinto and read
    sleep ``read_s`` first and its write ``write_s``; the write numbered
    ``fail_at`` (from 1, over every file) writes the first ``cut`` bytes
    and raises OSError.  ``opened`` records every file, to check that
    each was closed."""

    def __init__(self, read_s=0.0, write_s=0.0, fail_at=None, cut=0):
        self.read_s, self.write_s = read_s, write_s
        self.fail_at, self.cut = fail_at, cut
        self.writes = 0
        self.opened = []

    def open(self, *args, **kw):
        files = self

        class File:
            def __init__(self, f):
                self._f = f

            def readinto(self, b):
                time.sleep(files.read_s)
                return self._f.readinto(b)

            def read(self, *a):
                time.sleep(files.read_s)
                return self._f.read(*a)

            def write(self, b):
                time.sleep(files.write_s)
                files.writes += 1
                if files.writes == files.fail_at:
                    self._f.write(memoryview(b).cast("B")[: files.cut])
                    raise OSError(28, "No space left on device")
                return self._f.write(b)

            def __getattr__(self, name):
                return getattr(self._f, name)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self._f.close()

        f = File(open(*args, **kw))
        self.opened.append(f._f)
        return f

    def all_closed(self) -> bool:
        return bool(self.opened) and all(f.closed for f in self.opened)


@pytest.fixture
def one_torch_thread():
    """Torch's CPU ops on one thread for the test: the plain kernels' many
    small ops on a pool of threads in each of several test processes
    oversubscribe the cores (a hundred times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _slow(monkeypatch, **kw) -> SlowFiles:
    from gpuar_tpu_torch import pipeline

    files = SlowFiles(**kw)
    monkeypatch.setattr(pipeline, "open", files.open, raising=False)
    return files


def _text_mixed(rng, size: int) -> bytes:
    """Random bytes with every other 8192-byte packet text, so compressed
    packet lengths vary."""
    data = rng.integers(0, 256, size, np.uint8)
    text = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog. " * 200)[:P],
        np.uint8)
    for at in range(P, size, 2 * P):
        n = min(P, size - at)
        data[at: at + n] = text[:n]
    return data.tobytes()


def _threaded_case(tmp_path, backend: str, batches: int, ragged: bool):
    """A file of ``batches`` compress super-batches of two 8192-byte
    reads, its last packet ragged or not; the backend that compresses it,
    the one that decompresses it, and the JAX package's archive of it:
    HostCompressor's for the port's HostCompressor, and the JAX package's
    sleep control's for the port's.  GPUCompressor on two CPU shards runs
    at P = 64 (its plain kernels are slow at 8192 B) against the JAX
    golden codec's body at 64; it decompresses 256 packets a batch, the
    bytes of one compress read."""
    from benchmarks.sleep_backend import SleepCompressor as JaxSleep
    from gpuar_tpu_torch.bench.sleep_backend import SleepCompressor
    from gpuar_tpu_torch.pipeline import HostCompressor as PortHost

    size = (2 * batches - ragged) * P + 777 * ragged
    data = _text_mixed(np.random.default_rng(batches * 2 + ragged), size)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    if backend == "gpu":
        return (GPUCompressor(devices=[CPU, CPU], packet_size=64,
                              super_batch_packets=2),
                GPUCompressor(devices=[CPU, CPU], packet_size=64,
                              super_batch_packets=256),
                data, src, _jax_archive(data, 64))
    ref = tmp_path / "ref.gip"
    if backend == "host":
        port = PortHost(super_batch_packets=2)
        HostCompressor(super_batch_packets=2).compress(src, ref)
    else:
        port = SleepCompressor(gbps=50.0, super_batch_packets=2)
        JaxSleep(gbps=50.0, super_batch_packets=2).compress(src, ref)
    return port, port, data, src, ref.read_bytes()


@pytest.mark.parametrize("slow", ["read", "write"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("batches", [1, 2, 4])
@pytest.mark.parametrize("backend", ["host", "sleep", "gpu"])
def test_threaded_loops_with_slow_io(tmp_path, monkeypatch, one_torch_thread,
                                     backend, batches, ragged, slow):
    """With the reader or the writer slowed (each readinto or write sleeps
    first), 1, 2 and 4 super-batches, ragged or not, give the JAX
    package's archive and round-trip bit for bit; the accounting is the
    archive's, every file is closed and no loop thread is left."""
    port, unport, data, src, want = _threaded_case(tmp_path, backend,
                                                   batches, ragged)
    files = _slow(monkeypatch, **{f"{slow}_s": 0.004})
    gip, back = tmp_path / "port.gip", tmp_path / "back.bin"
    ci = bounded(port.compress, src, gip)
    assert gip.read_bytes() == want
    assert (ci.compressed_file_size, ci.processed_uncompressed_size) == \
        (len(want), len(data))
    di = bounded(unport.decompress, gip, back)
    assert back.read_bytes() == data
    assert di.processed_uncompressed_size == len(data)
    assert files.all_closed()
    assert loop_threads() == []


@pytest.mark.parametrize("verb", ["compress", "decompress"])
@pytest.mark.parametrize("backend", ["host", "gpu"])
@pytest.mark.parametrize("fail_at", [1, 2, 3])
def test_write_error_surfaces(tmp_path, monkeypatch, one_torch_thread,
                              backend, verb, fail_at):
    """An OSError from the writer thread's write (the first, a middle or
    the last body write of three batches) surfaces from the call as it
    was raised; every file is closed and no loop thread is left."""
    port, unport, data, src, want = _threaded_case(tmp_path, backend, 3,
                                                   True)
    gip = tmp_path / "port.gip"
    if verb == "decompress":
        gip.write_bytes(want)
        # The compress writes its zero header first; decompress does not.
        fail_at -= 1
    files = _slow(monkeypatch, write_s=0.002, fail_at=fail_at + 1, cut=5)
    with pytest.raises(OSError, match="No space left on device"):
        if verb == "compress":
            bounded(port.compress, src, gip)
        else:
            bounded(unport.decompress, gip, tmp_path / "back.bin")
    assert files.all_closed()
    assert loop_threads() == []


@pytest.mark.parametrize("backend", ["host", "gpu"])
@pytest.mark.parametrize("cut", ["body", "header", "boundary"])
def test_reader_error_surfaces(tmp_path, monkeypatch, one_torch_thread,
                               backend, cut):
    """A ContainerError from the reader thread (an archive cut inside the
    third batch's packet body or header) or from the totals check (cut at
    a packet boundary) surfaces with the JAX package's text, while the
    writer still writes earlier batches; files closed, no loop thread
    left."""
    from gpuar_tpu import container as jax_container

    _, port, data, src, want = _threaded_case(tmp_path, backend, 3, True)
    at = container.HEADER_LENGTH
    for _ in range(4):   # the fifth packet is in the last batch
        at += want[at] | want[at + 1] << 8
    bad = tmp_path / "bad.gip"
    bad.write_bytes(want[: at + {"body": 9, "header": 2, "boundary": 0}[cut]])
    with pytest.raises(jax_container.ContainerError) as theirs:
        HostCompressor().decompress(bad, tmp_path / "jax.bin")
    files = _slow(monkeypatch, write_s=0.003)
    with pytest.raises(container.ContainerError) as ours:
        bounded(port.decompress, bad, tmp_path / "back.bin")
    assert str(ours.value) == str(theirs.value)
    assert files.all_closed()
    assert loop_threads() == []


@pytest.mark.parametrize("backend", ["host", "gpu"])
@pytest.mark.parametrize("cut", [0, 7, 4000])
def test_resume_after_interrupted_threaded_compress(tmp_path, monkeypatch,
                                                    one_torch_thread,
                                                    backend, cut):
    """A threaded compress whose third body write dies after ``cut``
    bytes leaves a prefix that ``resume=True`` completes into the JAX
    package's archive byte for byte."""
    port, _, data, src, want = _threaded_case(tmp_path, backend, 4, True)
    gip = tmp_path / "port.gip"
    files = _slow(monkeypatch, write_s=0.002, fail_at=4, cut=cut)
    with pytest.raises(OSError):
        bounded(port.compress, src, gip)
    assert files.all_closed()
    monkeypatch.undo()
    info = bounded(port.compress, src, gip, resume=True)
    assert gip.read_bytes() == want
    assert info.compressed_file_size == len(want)
    assert loop_threads() == []


def test_lane_hands_errors_back_and_never_waits_on_an_ended_thread():
    """A job's exception is raised again by wait() as the same object; a
    lane whose thread has ended raises at once instead of waiting."""
    from gpuar_tpu_torch.pipeline import _Lane

    lane = _Lane("probe")
    err = container.ContainerError("Incorrect file format: probe")

    def fail():
        raise err

    lane.start(fail)
    with pytest.raises(container.ContainerError) as got:
        lane.wait()
    assert got.value is err
    lane.start(sum, [1, 2, 3])
    assert lane.wait() == 6
    lane.close()
    assert loop_threads() == []
    lane._done.clear()   # as if a job had been handed to the ended thread
    with pytest.raises(RuntimeError, match="probe thread ended"):
        bounded(lane.wait, timeout=10)


def test_threaded_loops_under_contention(tmp_path):
    """Eight compress and decompress round trips at once (each with its
    own reader and writer threads), the interpreter switching threads
    every microsecond: every archive is the JAX package's and every round
    trip exact (a lost or reordered write would break either)."""
    import threading

    from gpuar_tpu_torch.pipeline import HostCompressor as PortHost

    data = _text_mixed(np.random.default_rng(0x5EED), 9 * P + 4321)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    ref = tmp_path / "ref.gip"
    HostCompressor(super_batch_packets=1).compress(src, ref)
    results = {}

    def round_trip(i):
        gip, back = tmp_path / f"{i}.gip", tmp_path / f"{i}.bin"
        port = PortHost(super_batch_packets=1)
        port.compress(src, gip)
        port.decompress(gip, back)
        results[i] = (gip.read_bytes(), back.read_bytes())

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=round_trip, args=(i,))
                   for i in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert sorted(results) == list(range(8))
    for gip, back in results.values():
        assert gip == ref.read_bytes()
        assert back == data
    assert loop_threads() == []


# --- the splice of a batch ----------------------------------------------------

@pytest.mark.parametrize("last", [P, 1, 256, 8191])
def test_splice_of_ragged_batch_is_a_view(monkeypatch, rng, last):
    """When every packet but the last fills its stride, the body is a
    view of the batch's head (no native.splice), equal to the spliced
    bytes."""
    from gpuar_tpu_torch import native, pipeline

    calls = []
    monkeypatch.setattr(native, "splice", lambda *a: calls.append(a))
    batch = rng.integers(0, 256, (5, P), np.uint8)
    sizes = np.array([P] * 4 + [last], np.int32)
    body = pipeline._splice(batch, sizes)
    assert calls == []
    assert np.shares_memory(body, batch)
    assert body.tobytes() == batch.reshape(-1)[: 4 * P + last].tobytes()


@pytest.mark.parametrize("short_at", [0, 2, 3])
def test_splice_with_short_packet_before_last_copies(monkeypatch, rng,
                                                     short_at):
    """A short packet before the last (the container allows one) takes
    native.splice, and its bytes are the packets' heads in order."""
    from gpuar_tpu_torch import native, pipeline

    splice, calls = native.splice, []

    def recording(packets, lengths):
        calls.append(lengths.copy())
        return splice(packets, lengths)

    monkeypatch.setattr(native, "splice", recording)
    batch = rng.integers(0, 256, (5, P), np.uint8)
    sizes = np.array([P] * 4 + [300], np.int32)
    sizes[short_at] = 1000
    body = pipeline._splice(batch, sizes)
    assert len(calls) == 1
    assert not np.shares_memory(body, batch)
    assert body.tobytes() == b"".join(batch[i, : sizes[i]].tobytes()
                                      for i in range(5))
