"""MeshCodec: a batch split over several devices.

On the CPU, ``MeshCodec([cpu] * k)`` runs k shards with the kernels'
plain versions; the bodies, lengths and decoded bytes must equal one
DeviceCodec's and the JAX package's MeshCodec on the 8 virtual devices of
``tests/conftest.py`` (Pallas interpret mode), at 0 bytes of difference.
The GPU-marked test runs two shards on one card.
"""

import io

import numpy as np
import pytest
import torch

from gpuar_tpu import container
from gpuar_tpu.pipeline import _PacketReader
from gpuar_tpu_torch.parallel.codec import BUCKET_ROWS, DeviceCodec
from gpuar_tpu_torch.parallel.mesh import MeshCodec, shard_bounds
from gpuar_tpu_torch.parallel.runner import GPUCompressor

CPU = torch.device("cpu")
P = 64
N = 80


@pytest.fixture(scope="module")
def batch():
    """80 packets of 64 B: a short packet, an empty one and a compressible
    stretch (the shape of tests/test_sharding.py's batches)."""
    rng = np.random.default_rng(0x5AD)
    data = rng.integers(0, 256, (N, P), np.uint8)
    sizes = np.full(N, P, np.int32)
    sizes[7] = 13
    data[7, 13:] = 0
    sizes[63] = 0
    data[63] = 0
    data[10:30] = 7
    return data, sizes


@pytest.fixture(scope="module")
def reference(batch):
    """(body, lengths, stride packets) of one DeviceCodec, and the JAX
    MeshCodec's body and lengths on the 8-device virtual mesh."""
    from gpuar_tpu.parallel.mesh import MeshCodec as JaxMeshCodec, make_mesh

    data, sizes = batch
    one = DeviceCodec(CPU, packet_size=P)
    body, lengths = one.encode_body_wait(one.encode_body_async(data, sizes))
    packets, _ = one.encode(data, sizes)
    jax_codec = JaxMeshCodec(make_mesh(), tile=8, packet_size=P,
                             interpret=True)
    jpk, jlen = jax_codec.encode(data, sizes)
    jbody = b"".join(jpk[i, : jlen[i]].tobytes() for i in range(N))
    return body.tobytes(), lengths, packets, jbody, jlen


def _blob(body: bytes, n: int, row_bytes: int):
    return _PacketReader(io.BytesIO(body), max_raw=P).read_batch_blob(
        n, row_bytes, BUCKET_ROWS)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_encode_matches_one_codec_and_jax(k, batch, reference):
    data, sizes = batch
    body, lengths, _, jbody, jlen = reference
    mesh = MeshCodec([CPU] * k, packet_size=P)
    got, got_len = mesh.encode_body_wait(mesh.encode_body_async(data, sizes))
    np.testing.assert_array_equal(got_len, lengths)
    assert got.tobytes() == body
    np.testing.assert_array_equal(got_len, jlen)
    assert got.tobytes() == jbody


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_decode_blob_and_stride_forms(k, batch, reference):
    data, sizes = batch
    body, lengths, packets, _, _ = reference
    mesh = MeshCodec([CPU] * k, packet_size=P)
    blob, roff, comp_len, raw = _blob(body, N, mesh.row_bytes)
    out = mesh.decode_body_wait(
        mesh.decode_blob_async(blob, roff, comp_len, raw))
    np.testing.assert_array_equal(out, data)
    out = mesh.decode_body_wait(mesh.decode_async(packets, sizes))
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_debug_flags_come_back_in_packet_order(k, batch, reference):
    """A noise-bodied copy of a compressible packet at batch index 50 (in
    the last shard for k = 2 and 3) is reported as packet 50."""
    data, sizes = batch
    body, lengths, packets, _, _ = reference
    mesh = MeshCodec([CPU] * k, packet_size=P, debug=True)
    blob, roff, comp_len, raw = _blob(body, N, mesh.row_bytes)
    out = mesh.decode_body_wait(
        mesh.decode_blob_async(blob, roff, comp_len, raw))
    np.testing.assert_array_equal(out, data)

    bad = packets.copy()
    bad[50] = packets[15]          # a packet of the 0x07 stretch
    rng = np.random.default_rng(9)
    bad[50, 4: lengths[15]] = rng.integers(0, 256, lengths[15] - 4, np.uint8)
    with pytest.raises(container.ContainerError, match=r"packets \[50\]"):
        mesh.decode_body_wait(mesh.decode_async(bad, sizes))


@pytest.mark.parametrize("n,k", [(3, 8), (1, 2), (1, 3), (1, 8), (0, 2),
                                 (0, 8)])
def test_split_edges(n, k, batch):
    data, sizes = batch[0][:n], batch[1][:n]
    bounds = shard_bounds(n, k)
    assert [b - a for a, b in bounds] == [1] * n
    mesh = MeshCodec([CPU] * k, packet_size=P, debug=True)
    body, lengths = mesh.encode_body_wait(mesh.encode_body_async(data, sizes))
    assert lengths.shape == (n,) and body.size == int(lengths.sum())
    out = mesh.decode_body_wait(mesh.decode_async(
        np.zeros((n, 1), np.uint8) if n == 0 else
        _stride(body.tobytes(), lengths), sizes))
    assert out.shape == (n, P)
    np.testing.assert_array_equal(out, data)


def _stride(body: bytes, lengths) -> np.ndarray:
    packets = np.zeros((len(lengths), int(max(lengths))), np.uint8)
    pos = 0
    for i, ln in enumerate(lengths):
        packets[i, :ln] = np.frombuffer(body, np.uint8, ln, pos)
        pos += ln
    return packets


@pytest.mark.parametrize("n,k", [(80, 3), (10, 3), (7, 8), (30, 4)])
def test_shard_bounds_balanced_and_contiguous(n, k):
    bounds = shard_bounds(n, k)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(bounds, bounds[1:]))
    counts = [b - a for a, b in bounds]
    assert max(counts) - min(counts) <= 1 and len(bounds) == min(n, k)


def test_two_batches_in_flight(batch, reference):
    """The drive loops submit batch N+1 before they fetch batch N: both
    decoded batches must survive in the mesh's alternating buffers."""
    data, sizes = batch
    body, lengths, packets, _, _ = reference
    mesh = MeshCodec([CPU] * 3, packet_size=P)
    first = mesh.decode_async(packets, sizes)
    second = mesh.decode_async(packets[::-1].copy(), sizes[::-1].copy())
    np.testing.assert_array_equal(mesh.decode_body_wait(first), data)
    np.testing.assert_array_equal(mesh.decode_body_wait(second), data[::-1])


@pytest.fixture(scope="module")
def jax_archive(tmp_path_factory):
    """A 263,378-byte file (4116 packets of 64 B) and the archive of JAX's
    TPUCompressor on the 8-device mesh."""
    from gpuar_tpu.parallel.runner import TPUCompressor

    tmp = tmp_path_factory.mktemp("jax_archive")
    rng = np.random.default_rng(0x3E5)
    data = rng.integers(0, 256, 2 * 131072 + 1234, np.uint8)
    data[5000:90000] = 7
    data[140000:141000] = rng.integers(0, 3, 1000, np.uint8)
    src = tmp / "in.bin"
    src.write_bytes(data.tobytes())
    TPUCompressor(tile=8, packet_size=P).compress(src, tmp / "jax.gip")
    return src, tmp / "jax.gip"


@pytest.mark.parametrize("super_batch", [16, 8192])
def test_sharded_compressor_writes_the_jax_archive(tmp_path, jax_archive,
                                                   super_batch):
    """GPUCompressor over three CPU shards writes the JAX archive byte for
    byte: a super-batch of 16 reads 131072 B (2048 packets of 64 B) at a
    time, so the file is three batches, the last ragged; 8192 reads it
    whole.  Decoding in batches of 1500 packets (the last ragged) gives
    the file back."""
    src, ref = jax_archive
    GPUCompressor(devices=[CPU] * 3, packet_size=P,
                  super_batch_packets=super_batch).compress(
        src, tmp_path / "port.gip")
    assert (tmp_path / "port.gip").read_bytes() == ref.read_bytes()
    GPUCompressor(devices=[CPU] * 3, packet_size=P,
                  super_batch_packets=1500).decompress(
        tmp_path / "port.gip", tmp_path / "back.bin")
    assert (tmp_path / "back.bin").read_bytes() == src.read_bytes()


@pytest.mark.gpu
def test_gpu_two_shards_on_one_card_equal_one_codec():
    from gpuar_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (301, 8192), np.uint8)
    data[100:200] = 0
    sizes = np.full(301, 8192, np.int32)
    sizes[-1] = 77
    data[-1, 77:] = 0
    one = DeviceCodec(cuda)
    body, lengths = one.encode_body_wait(one.encode_body_async(data, sizes))
    _kernels.reset_counts()
    mesh = MeshCodec([cuda, cuda], debug=True)
    got, got_len = mesh.encode_body_wait(mesh.encode_body_async(data, sizes))
    np.testing.assert_array_equal(got_len, lengths)
    assert got.tobytes() == body.tobytes()
    blob, roff, comp_len, raw = _PacketReader(
        io.BytesIO(body.tobytes())).read_batch_blob(301, mesh.row_bytes,
                                                    BUCKET_ROWS)
    out = mesh.decode_body_wait(
        mesh.decode_blob_async(blob, roff, comp_len, raw))
    np.testing.assert_array_equal(out, data)
    for codec in mesh.codecs:
        counts = codec.launches()
        assert counts["encode"] == 1 and counts["decode_debug"] == 1, counts
