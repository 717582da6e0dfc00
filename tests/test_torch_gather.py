"""G1 (``ops.encode.gather_body``): a batch's ``.gip`` body gathered from
K1's fixed-stride rows on the device.

On the CPU the wrapper runs its plain version, held here at 0 bytes to
the JAX package's body of the same packets: its golden codec's
``native.splice`` of the stride packets, and its MeshCodec's
``encode_body`` (the row compaction and the host splice; Pallas interpret
mode).  The spy tests show that the port's compress path splices nothing
on the host, through GPUCompressor on 1-3 CPU shards and through
DistributedCompressor at world 1, and writes the JAX package's archive.
The GPU-marked test holds the kernel to its plain version on the card at
unaligned offsets.  JAX and the JAX package are imported only inside the
CPU tests, so the file collects where they are missing.
"""

import numpy as np
import pytest
import torch

from gpuar_tpu_torch import native as port_native
from gpuar_tpu_torch.ops import _kernels, encode
from gpuar_tpu_torch.parallel import distributed
from gpuar_tpu_torch.parallel.runner import GPUCompressor

CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _jax_native():
    from test_torch_host import jax_native

    return jax_native()


def _lengths(case: str, stride: int, rng) -> np.ndarray:
    """Ragged lengths of one case, each in [0, stride]."""
    if case == "short_middle":
        n = np.full(9, stride, np.int32)
        n[4] = 37
    elif case == "short_last":
        n = np.full(7, stride, np.int32)
        n[-1] = 5
    elif case == "one":
        n = np.array([stride // 3], np.int32)
    elif case == "full":
        n = np.full(5, stride, np.int32)
    else:   # "ragged": every length from empty to the full stride
        n = rng.integers(0, stride + 1, 40).astype(np.int32)
        n[:4] = (0, 1, stride, 4)
    return n


STRIDES = [encode.out_geometry(p)[1] * 4 for p in (64, 8192)]   # 608, 8736


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("case", ["short_middle", "short_last", "one",
                                  "full", "ragged"])
def test_plain_body_equals_jax_splice(case, stride):
    """The body of stride packets of random bytes at ragged lengths is the
    JAX package's ``native.splice`` of them; the bytes past it are zero."""
    rng = np.random.default_rng(stride + len(case))
    lengths = _lengths(case, stride, rng)
    packets = rng.integers(0, 256, (lengths.size, stride), np.uint8)
    want = _jax_native().splice(packets, lengths)
    body, total = encode.gather_body(torch.from_numpy(packets),
                                     torch.from_numpy(lengths))
    assert int(total) == want.size == int(lengths.sum())
    assert body.shape == (lengths.size * stride,)
    np.testing.assert_array_equal(body[: want.size].numpy(), want)
    assert not body[want.size:].any()


@pytest.mark.parametrize("n", [1, 13, 80])
def test_gathered_k1_body_equals_jax_mesh_encode_body(n):
    """K1 then G1 (both plain) on n packets of 64 B, a short packet in the
    middle, an empty one and a short last one, equal the JAX MeshCodec's
    ``encode_body`` on the 8-device virtual mesh (interpret mode)."""
    from gpuar_tpu.parallel.mesh import MeshCodec, make_mesh

    _jax_native()
    rng = np.random.default_rng(0x61 + n)
    data = rng.integers(0, 256, (n, 64), np.uint8)
    data[n // 3: n // 2] = 9
    sizes = np.full(n, 64, np.int32)
    sizes[n // 2] = 11
    sizes[-1] = 30
    if n > 2:
        sizes[1] = 0
    for i, s in enumerate(sizes):
        data[i, s:] = 0
    jbody, jlen = MeshCodec(make_mesh(), tile=8, packet_size=64,
                            interpret=True).encode_body(data, sizes)
    packets, lengths = encode.encode_batch(torch.from_numpy(data),
                                           torch.from_numpy(sizes))
    body, total = encode.gather_body(packets, lengths)
    np.testing.assert_array_equal(lengths.numpy(), jlen)
    assert body[: int(total)].numpy().tobytes() == jbody.tobytes()


def test_gather_body_refuses_what_it_does_not_take():
    """Bad dtypes or shapes raise, and a tensor on neither the CPU nor a
    CUDA device raises rather than taking the plain version."""
    pk = torch.zeros((3, 16), dtype=torch.uint8)
    ln = torch.full((3,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="packets must be uint8"):
        encode.gather_body(pk.to(torch.int32), ln)
    with pytest.raises(ValueError, match="lengths must be"):
        encode.gather_body(pk, ln[:2])
    with pytest.raises(ValueError, match="unsupported device"):
        encode.gather_body(pk.to("meta"), ln.to("meta"))


@pytest.fixture
def no_splice(monkeypatch):
    """Every call of the port's ``native.splice`` and ``native.splice_at``,
    recorded by name (the calls still run)."""
    calls = []
    for name in ("splice", "splice_at"):
        real = getattr(port_native, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(port_native, name, spy)
    return calls


def _file(tmp_path, seed: int):
    """A 64-byte-packet file of 4 super-batches of 16 packets, the last
    ragged, with a compressible stretch, and its JAX archive."""
    data = np.random.default_rng(seed).integers(0, 256, 3 * 1024 + 777,
                                                np.uint8)
    data[500:1500] = 3
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    from gpuar_tpu import container

    body = _jax_native().encode_stream(data.tobytes(), 64)
    ref = container.FileHeader(
        uncompressed_size=data.size,
        compressed_size=container.HEADER_LENGTH + len(body)).to_bytes() + body
    return src, ref


@pytest.mark.parametrize("k", [1, 2, 3])
def test_gpu_compressor_compress_splices_nothing(tmp_path, no_splice, k):
    """GPUCompressor over k CPU shards writes the JAX archive with no call
    of native.splice or native.splice_at (the spy does see a direct
    call)."""
    src, ref = _file(tmp_path, 0x5B1 + k)
    GPUCompressor(devices=[CPU] * k, packet_size=64,
                  super_batch_packets=16).compress(src, tmp_path / "c.gip")
    assert no_splice == []
    assert (tmp_path / "c.gip").read_bytes() == ref
    port_native.splice(np.zeros((1, 8), np.uint8), np.array([3], np.int32))
    assert no_splice == ["splice"]


@pytest.mark.parametrize("k", [1, 2])
def test_distributed_compress_at_world_1_splices_nothing(tmp_path,
                                                         monkeypatch,
                                                         no_splice, k):
    """DistributedCompressor at world 1 (no process group) over a
    GPUCompressor of k CPU shards: its own compress loop writes the JAX
    archive with no call of native.splice or native.splice_at."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    src, ref = _file(tmp_path, 0xD1 + k)
    d = distributed.DistributedCompressor(backend=GPUCompressor(
        devices=[CPU] * k, packet_size=64, super_batch_packets=16))
    d.compress(src, tmp_path / "d.gip")
    assert no_splice == []
    assert (tmp_path / "d.gip").read_bytes() == ref


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 301, 4224])
def test_gpu_gather_matches_plain_at_unaligned_offsets(cuda, n):
    """G1 on the card, launched once, against its plain version on the same
    card tensors and on the CPU at 0: stride 8736, ragged lengths with the
    first packet one byte long, so every later offset starts unaligned,
    and empty and full-stride packets among them."""
    stride = STRIDES[1]
    rng = np.random.default_rng(n)
    lengths = rng.integers(0, stride + 1, n).astype(np.int32)
    lengths[: min(n, 4)] = (1, 0, stride, 4097)[: min(n, 4)]
    packets = rng.integers(0, 256, (n, stride), np.uint8)
    pk, ln = torch.from_numpy(packets).to(cuda), \
        torch.from_numpy(lengths).to(cuda)
    before = _kernels.LAUNCHES["gather"]
    body, total = encode.gather_body(pk, ln)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["gather"] == before + 1
    plain, plain_total = encode.gather_body_plain(pk, ln)
    want, want_total = encode.gather_body(torch.from_numpy(packets),
                                          torch.from_numpy(lengths))
    assert int(total) == int(plain_total) == int(want_total) \
        == int(lengths.sum())
    t = int(total)
    assert torch.equal(body[:t], plain[:t])
    assert torch.equal(body[:t].cpu(), want[:t])
