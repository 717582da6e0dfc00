"""Archive mutations through the port's decoders, held to the JAX package's.

The port's counterpart of ``tests/test_container.py::
test_corrupted_container_never_crashes``, on archives of three
super-batches at ``super_batch_packets=2`` (two, two and one packets, the
last ragged), so the threaded drive loop has batches in flight when a
fault shows.  Seeded single-byte changes, bit flips, truncations and
extensions of the file header and of the body go through:

- the JAX package's ``HostCompressor.decompress`` (the oracle) and the
  port's ``HostCompressor``: the port raises ``ContainerError`` with the
  JAX package's text exactly where it raises, and otherwise writes the
  same bytes;
- ``GPUCompressor`` on a CPU device (P = 64: its plain kernels are slow at
  8192 B; a GPU-marked twin runs cuda:0 at 8192 B): it writes the header's
  raw size in bytes or raises ``ContainerError``, never another exception,
  and raises wherever the oracle rejects the framing;
- under ``debug=True``, packets corrupted but still well framed: the port
  raises with the text of the JAX package's debug decoder
  (``TPUCompressor(debug=True)``, Pallas interpret mode) where it raises.

Every call runs bounded (``test_torch_pipeline.bounded``) and leaves no
drive-loop thread alive.
"""

import numpy as np
import pytest
import torch

from gpuar_tpu import container as jax_container
from gpuar_tpu.pipeline import HostCompressor as JaxHost
from gpuar_tpu_torch import container
from gpuar_tpu_torch.parallel.runner import GPUCompressor
from gpuar_tpu_torch.pipeline import HostCompressor as PortHost
from test_torch_host import jax_native
from test_torch_pipeline import bounded, loop_threads, one_torch_thread  # noqa: F401

KINDS = ("byte", "bit", "truncate", "extend")
REGIONS = ("header", "body")
TRIALS = 6
SIZE_MISMATCH = "Incorrect file format: decoded size mismatch"
CPU = torch.device("cpu")


def _archive(psize: int) -> tuple[bytes, bytes]:
    """Four packets and a ragged fifth at packet size psize (random, text,
    a run, random, a 37-byte tail) and the JAX golden codec's archive of
    them."""
    rng = np.random.default_rng(0xF022 + psize)
    data = rng.integers(0, 256, 4 * psize + 37, np.uint8)
    data[psize: 2 * psize] = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog. " * 200)[:psize],
        np.uint8)
    data[2 * psize: 3 * psize] = 7
    body = jax_native().encode_stream(data.tobytes(), psize)
    head = jax_container.FileHeader(
        uncompressed_size=data.size,
        compressed_size=jax_container.HEADER_LENGTH + len(body)).to_bytes()
    return data.tobytes(), head + body


def mutate(blob: bytes, kind: str, region: str, rng) -> bytes:
    """One seeded mutation of blob inside the file header or the body: a
    byte changed, a bit flipped, the file cut inside the region, or 1-64
    random bytes inserted into it (at the body's end: appended)."""
    lo, hi = (0, container.HEADER_LENGTH) if region == "header" \
        else (container.HEADER_LENGTH, len(blob))
    out = bytearray(blob)
    if kind == "byte":
        at = int(rng.integers(lo, hi))
        out[at] = (out[at] + int(rng.integers(1, 256))) % 256
    elif kind == "bit":
        at = int(rng.integers(lo, hi))
        out[at] ^= 1 << int(rng.integers(0, 8))
    elif kind == "truncate":
        del out[int(rng.integers(lo, hi)):]
    else:
        at = int(rng.integers(lo, hi + 1))
        out[at:at] = rng.integers(0, 256, int(rng.integers(1, 65)),
                                  np.uint8).tobytes()
    return bytes(out)


def outcome(codec, src, dst, error) -> tuple[str, object]:
    """("ok", the bytes written) or ("error", the message) of a bounded
    ``codec.decompress``; an exception other than ``error`` fails the
    test.  No drive-loop thread may be left either way."""
    try:
        bounded(codec.decompress, src, dst, timeout=60)
        result = ("ok", dst.read_bytes())
    except error as err:
        result = ("error", str(err))
    assert loop_threads() == []
    return result


def check_device(got, theirs, blob) -> None:
    """A device decode writes the header's raw size or raises
    ContainerError, and raises wherever the oracle rejects the framing."""
    if got[0] == "ok":
        header = container.FileHeader.from_bytes(blob[: container.HEADER_LENGTH])
        assert len(got[1]) == header.uncompressed_size
        assert theirs[0] == "ok" or theirs[1] == SIZE_MISMATCH, theirs


def fuzz(tmp_path, blob, kind, region, seed, device, psize) -> int:
    """TRIALS mutations of blob, each through the JAX package's host
    decode, the port's and the device decode; -> the trials the oracle
    rejected."""
    rng = np.random.default_rng(seed)
    gpu = GPUCompressor(devices=[device], packet_size=psize,
                        super_batch_packets=2)
    bad, rejected = tmp_path / "bad.gip", 0
    for _ in range(TRIALS):
        mutated = mutate(blob, kind, region, rng)
        bad.write_bytes(mutated)
        theirs = outcome(JaxHost(super_batch_packets=2), bad,
                         tmp_path / "jax.bin", jax_container.ContainerError)
        ours = outcome(PortHost(super_batch_packets=2), bad,
                       tmp_path / "port.bin", container.ContainerError)
        assert ours == theirs
        check_device(outcome(gpu, bad, tmp_path / "gpu.bin",
                             container.ContainerError), theirs, mutated)
        rejected += theirs[0] == "error"
    return rejected


@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_mutated_archive_decodes_like_jax(tmp_path, one_torch_thread, kind,
                                          region):
    """Seeded mutations of a three-batch P = 64 archive give the JAX
    package's outcome on the port's host decode and a clean one on the
    CPU device decode."""
    data, blob = _archive(64)
    seed = 0xF022 + 16 * KINDS.index(kind) + REGIONS.index(region)
    rejected = fuzz(tmp_path, blob, kind, region, seed, CPU, 64)
    if kind == "truncate":
        assert rejected == TRIALS   # a cut file never decodes


def _packet_spans(blob: bytes) -> list[tuple[int, int]]:
    """(offset, framed length) of each packet of a clean archive."""
    at, spans = container.HEADER_LENGTH, []
    while at < len(blob):
        total = blob[at] | blob[at + 1] << 8
        spans.append((at, total))
        at += total
    return spans


DEBUG_ERROR = ("Corrupt packet data: coder invariant violation or "
               "bitstream overrun in packets [{}]")


@pytest.mark.parametrize("how", ["noise", "byte", "bit"])
@pytest.mark.parametrize("seed", range(3))
def test_debug_decode_raises_on_corrupt_framed_packet(tmp_path,
                                                      one_torch_thread,
                                                      seed, how):
    """A packet's bitstream corrupted with its framing kept (one byte
    changed, one bit flipped, or all of it noise in a compressible
    packet, the text or the run): the port's debug decode raises exactly
    where the JAX package's debug decoder does, naming the same packet
    (its index in its super-batch of two; the JAX decoder's one batch
    holds all five), and otherwise writes the raw size.  Noise in a
    compressible packet always raises; in a random one it decodes as any
    random stream would, on either side."""
    from gpuar_tpu.parallel.runner import TPUCompressor

    data, blob = _archive(64)
    spans = _packet_spans(blob)
    rng = np.random.default_rng(0xDEB + 8 * seed + len(how))
    i = int(rng.integers(1, 3)) if how == "noise" \
        else int(rng.integers(0, len(spans)))
    at, total = spans[i]
    out = bytearray(blob)
    if how == "noise":
        out[at + 4: at + total] = rng.integers(0, 256, total - 4,
                                               np.uint8).tobytes()
    elif how == "byte":
        k = at + int(rng.integers(4, total))
        out[k] = (out[k] + int(rng.integers(1, 256))) % 256
    else:
        out[at + int(rng.integers(4, total))] ^= 1 << int(rng.integers(0, 8))
    bad = tmp_path / "bad.gip"
    bad.write_bytes(bytes(out))
    theirs = outcome(TPUCompressor(device_index=0, tile=8, packet_size=64,
                                   super_batch_packets=2, debug=True),
                     bad, tmp_path / "jax.bin", jax_container.ContainerError)
    ours = outcome(GPUCompressor(devices=[CPU], packet_size=64,
                                 super_batch_packets=2, debug=True),
                   bad, tmp_path / "port.bin", container.ContainerError)
    if theirs[0] == "error":
        assert theirs[1] == DEBUG_ERROR.format(i)
        assert ours == ("error", DEBUG_ERROR.format(i % 2))
    else:
        assert ours[0] == "ok" and len(ours[1]) == len(data)
    if how == "noise":
        assert ours[0] == "error"


@pytest.mark.gpu
@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_gpu_mutated_archive_decodes_like_jax(tmp_path, kind, region):
    """The CPU fuzz on cuda:0 at 8192-byte packets: the port's host decode
    gives the JAX package's outcome, the GPU decode a clean one and,
    where the oracle rejects the framing, its text."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data, blob = _archive(8192)
    seed = 0x6F22 + 16 * KINDS.index(kind) + REGIONS.index(region)
    fuzz(tmp_path, blob, kind, region, seed, torch.device("cuda", 0), 8192)
