"""The port's plain PyTorch codec (gpuar_tpu_torch.ops.torch_codec) against
the JAX spec codec (gpuar_tpu.ops.xla_codec) and the native golden codec.

This is an integer codec, so every comparison is exact (0 bytes of
tolerance).  Module-level imports are JAX-free so that the GPU-marked
tests of the port can run where JAX is not installed (with
``--noconftest``); the JAX references are imported inside the tests.
"""

import numpy as np
import pytest
import torch

from gpuar_tpu import native
from gpuar_tpu_torch.ops import encode as enc_ops
from gpuar_tpu_torch.ops import torch_codec
from test_torch_host import jax_native


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


def to_batch(chunks, packet_size):
    """Pad byte chunks into [B, packet_size] uint8 + int32 sizes."""
    data = np.zeros((len(chunks), packet_size), np.uint8)
    sizes = np.zeros(len(chunks), np.int32)
    for i, c in enumerate(chunks):
        data[i, : len(c)] = np.frombuffer(c, np.uint8)
        sizes[i] = len(c)
    return data, sizes


def golden_stride(data, sizes, stride):
    """Golden-encoded packets laid out at a fixed stride."""
    packets = np.zeros((data.shape[0], stride), np.uint8)
    for i in range(data.shape[0]):
        e = native.encode_packet(data[i, : sizes[i]].tobytes())
        packets[i, : len(e)] = np.frombuffer(e, np.uint8)
    return packets


def mixed_batch(rng, P=128):
    """Content classes with ragged, 1-byte and empty lanes."""
    data = np.zeros((10, P), np.uint8)
    data[0] = rng.integers(0, 256, P, np.uint8)
    data[1] = 0xFF
    data[2] = rng.integers(126, 130, P, np.uint8)      # underflow-heavy
    data[3] = np.arange(P) % 256
    data[4:] = rng.integers(0, 4, (6, P), np.uint8)    # skewed
    sizes = np.full(10, P, np.int32)
    sizes[5], sizes[6], sizes[7] = 0, 1, 37
    for i, s in enumerate(sizes):
        data[i, s:] = 0
    return data, sizes


@pytest.mark.parametrize("packet_size", [64, 128, 512, 8192])
def test_out_geometry_matches_pallas(packet_size):
    from gpuar_tpu.ops import pallas_encode

    assert enc_ops.out_geometry(packet_size) == \
        pallas_encode.out_geometry(packet_size)


def test_encode_scan_matches_xla(rng):
    import jax.numpy as jnp

    from gpuar_tpu.ops import xla_codec

    data, sizes = mixed_batch(rng)
    want = xla_codec.encode_scan(jnp.asarray(data.T, jnp.int32),
                                 jnp.asarray(sizes))
    got = torch_codec.encode_scan(torch.from_numpy(data.T.copy()),
                                  torch.from_numpy(sizes))
    for name, w, g in zip(("desc", "pat", "tail_bit", "tail_run"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_decode_scan_matches_xla(rng):
    import jax.numpy as jnp

    from gpuar_tpu.ops import xla_codec

    P = 128
    data, sizes = mixed_batch(rng, P)
    packets = golden_stride(data, sizes, enc_ops.out_geometry(P)[1] * 4)
    words = xla_codec.packets_to_words(packets)
    t_words = torch_codec.packets_to_words(torch.from_numpy(packets))
    np.testing.assert_array_equal(t_words.numpy(), words.astype(np.int64))
    want = np.asarray(xla_codec.decode_scan(jnp.asarray(words),
                                            jnp.asarray(sizes), P))
    got = torch_codec.decode_scan(t_words, torch.from_numpy(sizes), P)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().T, data)


def test_plain_codec_matches_native_on_fixture_corpora(rng):
    """Boundary sizes and content classes (tests/conftest.py), split into
    8192-byte packets: encode equals the golden bytes, decode returns the
    data."""
    from tests.conftest import fixture_corpora

    P = 8192
    chunks = []
    for _, blob in fixture_corpora(rng, max_size=512):
        chunks += [blob[o: o + P] for o in range(0, max(len(blob), 1), P)]
    data, sizes = to_batch(chunks, P)
    stride = enc_ops.out_geometry(P)[1] * 4
    packets, lengths = torch_codec.encode_packets(
        torch.from_numpy(data), torch.from_numpy(sizes), stride)
    for i, c in enumerate(chunks):
        assert packets[i, : lengths[i]].numpy().tobytes() == \
            native.encode_packet(c), f"lane {i} (len {len(c)})"
    raw = torch_codec.decode_packets(packets, torch.from_numpy(sizes), P)
    np.testing.assert_array_equal(raw.numpy(), data)


@pytest.mark.gpu
def test_plain_codec_on_cuda_matches_cpu(cuda):
    """The plain versions give the same bytes on the card as on the CPU
    (they are the kernels' references there)."""
    data, sizes = mixed_batch(np.random.default_rng(7))
    stride = enc_ops.out_geometry(data.shape[1])[1] * 4
    d, s = torch.from_numpy(data), torch.from_numpy(sizes)
    pk_c, ln_c = torch_codec.encode_packets(d, s, stride)
    pk_g, ln_g = torch_codec.encode_packets(d.to(cuda), s.to(cuda), stride)
    assert torch.equal(ln_g.cpu(), ln_c) and torch.equal(pk_g.cpu(), pk_c)
    raw_c, fl_c = torch_codec.decode_packets(pk_c, s, data.shape[1],
                                             debug=True)
    raw_g, fl_g = torch_codec.decode_packets(pk_g, s.to(cuda), data.shape[1],
                                             debug=True)
    assert torch.equal(raw_g.cpu(), raw_c) and torch.equal(fl_g.cpu(), fl_c)
