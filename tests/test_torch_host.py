"""The port's own host layer against the JAX package's, at 0 bytes.

``gpuar_tpu_torch`` keeps copies of the host modules it runs (config,
container, the native golden codec, the pipeline's drive loops, reader,
``HostCompressor`` and ``verify_archive``).  Each copy is held here to the
JAX package's module of the same name: the same packets, headers, blobs,
archives and verdicts, byte for byte.

``jax_native`` is the one way the port's tests load the JAX package's
golden codec, the oracle behind ``HostCompressor``, ``_PacketReader``,
``TPUCompressor`` and ``native.*``.  That loader compiles into one fixed
temporary file name, so test workers that build it at once in a fresh
checkout can load a half-written library ("file too short") or lose their
temporary file (``FileNotFoundError``).  A failed load leaves the loader
unset and the racing build finishes within seconds, so a bounded retry
gets the finished library.
"""

import functools
import io
import subprocess
import time

import numpy as np
import pytest

from gpuar_tpu_torch import container as port_container
from gpuar_tpu_torch import native as port_native
from gpuar_tpu_torch import pipeline as port_pipeline

P = 8192


def jax_native(tries: int = 40, wait: float = 0.25):
    """The JAX package's golden codec module, its library loaded; retries a
    load that fails while another process builds it."""
    from gpuar_tpu import native

    for attempt in range(tries):
        try:
            native.load()
            return native
        except (OSError, subprocess.CalledProcessError):
            if attempt == tries - 1:
                raise
            time.sleep(wait)


@pytest.fixture(scope="module", autouse=True)
def jax_golden():
    return jax_native()


# The cases of tests/conftest.py::fixture_corpora, by name (that module
# imports jax, so it is imported only where a CPU test runs).
CORPUS_NAMES = [f"random_{s}" for s in (0, 1, 2, 15, 16, 17, 255, 4096, 8191,
                                        8192, 8193, 16384, 20000)] \
    + ["all_zero", "all_ff", "text", "skewed"]


@functools.lru_cache(maxsize=None)
def corpora() -> dict[str, bytes]:
    from tests.conftest import fixture_corpora

    return dict(fixture_corpora(np.random.default_rng(0x4057)))


def _chunks(blob: bytes) -> list[bytes]:
    return [blob[o: o + P] for o in range(0, max(len(blob), 1), P)]


@pytest.mark.parametrize("case", CORPUS_NAMES)
def test_native_packets_equal_jax(case, jax_golden):
    """encode_packet, decode_packet and decode_packet_delta of every
    8192-byte chunk, and encode_batch / decode_batch of the whole case."""
    blob = corpora()[case]
    for chunk in _chunks(blob):
        pkt = port_native.encode_packet(chunk)
        assert pkt == jax_golden.encode_packet(chunk)
        assert port_native.decode_packet(pkt) == \
            jax_golden.decode_packet(pkt) == chunk
        assert port_native.decode_packet_delta(pkt) == \
            jax_golden.decode_packet_delta(pkt)
    raw = np.frombuffer(blob, np.uint8)
    pk, ln = port_native.encode_batch(raw)
    jpk, jln = jax_golden.encode_batch(raw)
    np.testing.assert_array_equal(ln, jln)
    np.testing.assert_array_equal(pk, jpk)
    out, lens = port_native.decode_batch(pk)
    jout, jlens = jax_golden.decode_batch(jpk)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(lens, jlens)


@pytest.mark.parametrize("row_bytes", [1, 96, 128])
def test_native_splice_and_expand_equal_jax(row_bytes, jax_golden):
    """splice_at strips a row-aligned blob to the body, expand_at scatters
    the body back, and splice concatenates stride rows: each equal to the
    JAX package's, on the packets of every corpus."""
    packets = [port_native.encode_packet(c) for blob in corpora().values()
               for c in _chunks(blob)]
    lengths = np.array([len(p) for p in packets], np.int32)
    rows = -(-lengths // row_bytes)
    offsets = np.zeros(len(packets), np.int64)
    np.cumsum(rows[:-1] * row_bytes, out=offsets[1:])
    cap = int(offsets[-1] + rows[-1] * row_bytes) + 2 * row_bytes
    body = np.frombuffer(b"".join(packets), np.uint8)
    blob = port_native.expand_at(body, offsets, lengths, cap)
    np.testing.assert_array_equal(
        blob, jax_golden.expand_at(body, offsets, lengths, cap))
    got = port_native.splice_at(blob, offsets, lengths)
    np.testing.assert_array_equal(
        got, jax_golden.splice_at(blob, offsets, lengths))
    assert got.tobytes() == body.tobytes()
    stride = np.zeros((len(packets), int(lengths.max())), np.uint8)
    for i, p in enumerate(packets):
        stride[i, : len(p)] = np.frombuffer(p, np.uint8)
    np.testing.assert_array_equal(port_native.splice(stride, lengths),
                                  jax_golden.splice(stride, lengths))
    with pytest.raises(ValueError, match="out of range"):
        port_native.splice_at(blob, offsets + cap, lengths)


@pytest.mark.parametrize("size", [0, 1, P - 1, P, P + 1, 3 * P + 77])
@pytest.mark.parametrize("kind", ["random", "zeros", "text"])
def test_native_stream_codec_equals_jax(size, kind, jax_golden):
    """encode_stream / decode_stream on boundary sizes: the body equals
    the JAX package's (bytes and numpy in), and decodes back."""
    rng = np.random.default_rng(size)
    data = {"random": rng.integers(0, 256, size, np.uint8),
            "zeros": np.zeros(size, np.uint8),
            "text": np.frombuffer((b"stream of text, " * (size // 16 + 1))
                                  [:size], np.uint8)}[kind]
    body = port_native.encode_stream(data)
    assert body == jax_golden.encode_stream(data)
    assert port_native.encode_stream(data.tobytes()) == body
    assert port_native.decode_stream(body, size) == \
        jax_golden.decode_stream(body, size) == data.tobytes()
    assert port_native.decode_stream(np.frombuffer(body, np.uint8),
                                     size + 100) == data.tobytes()


def test_native_stream_decode_errors_equal_jax(jax_golden):
    """Its two error codes: malformed framing (-1) and an output past
    ``out_cap`` (-2), each a ValueError with the JAX package's message."""
    data = np.random.default_rng(3).integers(0, 256, 2 * P + 5, np.uint8)
    body = port_native.encode_stream(data)
    bad = bytearray(body)
    bad[0:2] = (3).to_bytes(2, "little")        # total below the header
    for args in ((bytes(bad), data.size), (body[:-1], data.size),
                 (body, data.size - 1), (body, 0)):
        with pytest.raises(ValueError) as theirs:
            jax_golden.decode_stream(*args)
        with pytest.raises(ValueError) as ours:
            port_native.decode_stream(*args)
        assert str(ours.value) == str(theirs.value)
    assert "malformed" in str(ours.value) or "overflow" in str(ours.value)
    with pytest.raises(ValueError, match="malformed packet framing"):
        port_native.decode_stream(body[:-1], data.size)
    with pytest.raises(ValueError, match="decode output overflow"):
        port_native.decode_stream(body, data.size - 1)


def _reference_header(raw_size: int, comp_size: int) -> bytes:
    """A header as the reference writes it: u32 sizes, garbage above."""
    raw = bytearray(port_container.FileHeader(raw_size, comp_size).to_bytes())
    raw[3] = 0xDE
    raw[8:12] = b"\xca\xfe\xba\xbe"
    raw[16:20] = b"\xde\xad\xbe\xef"
    return bytes(raw)


@pytest.mark.parametrize("sizes", [(0, 20), (5000, 4321), (1 << 32, 77),
                                   (5 * (1 << 32), 5 * (1 << 32) + 20)])
def test_file_header_round_trip_equals_jax(sizes):
    from gpuar_tpu import container as jax_container

    raw_size, comp_size = sizes
    mine = port_container.FileHeader(raw_size, comp_size)
    theirs = jax_container.FileHeader(raw_size, comp_size)
    assert mine.to_bytes() == theirs.to_bytes()
    back = port_container.FileHeader.from_bytes(mine.to_bytes(),
                                                 actual_file_size=comp_size)
    assert (back.uncompressed_size, back.compressed_size) == sizes
    if comp_size < 1 << 32 and raw_size < 1 << 32:
        ref = _reference_header(raw_size, comp_size)
        a = port_container.FileHeader.from_bytes(ref, comp_size)
        b = jax_container.FileHeader.from_bytes(ref, comp_size)
        assert (a.uncompressed_size, a.compressed_size) == \
            (b.uncompressed_size, b.compressed_size) == sizes
    bad = bytearray(mine.to_bytes())
    bad[1] = 9
    with pytest.raises(port_container.ContainerError, match="version"):
        port_container.FileHeader.from_bytes(bytes(bad))
    with pytest.raises(port_container.ContainerError, match="truncated"):
        port_container.FileHeader.from_bytes(mine.to_bytes()[:19])


def _mixed_file(path, seed: int, size: int):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size, np.uint8)
    data[P: 2 * P] = 0
    data[2 * P: 3 * P] = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog. " * 200)[:P],
        np.uint8)
    path.write_bytes(data.tobytes())
    return data.tobytes()


@pytest.mark.parametrize("threads,super_batch", [(1, 8192), (3, 2), (1, 1)])
def test_host_compressor_archive_equals_jax(tmp_path, threads, super_batch):
    """The port's HostCompressor writes the JAX HostCompressor's archive,
    and each one decodes the other's."""
    from gpuar_tpu.pipeline import HostCompressor as JaxHost

    src = tmp_path / "in.bin"
    data = _mixed_file(src, 0x4051 + threads, 7 * P + 1234)
    port = port_pipeline.HostCompressor(threads=threads,
                                        super_batch_packets=super_batch)
    jax = JaxHost(threads=threads, super_batch_packets=super_batch)
    port.compress(src, tmp_path / "port.gip")
    jax.compress(src, tmp_path / "jax.gip")
    assert (tmp_path / "port.gip").read_bytes() == \
        (tmp_path / "jax.gip").read_bytes()
    port.decompress(tmp_path / "jax.gip", tmp_path / "a.bin")
    jax.decompress(tmp_path / "port.gip", tmp_path / "b.bin")
    assert (tmp_path / "a.bin").read_bytes() == data
    assert (tmp_path / "b.bin").read_bytes() == data


@pytest.mark.parametrize("row_bytes,bucket_rows,max_packets",
                         [(96, 4096, 8192), (96, 64, 3), (128, 7, 5)])
def test_packet_reader_blob_equals_jax(tmp_path, row_bytes, bucket_rows,
                                       max_packets, jax_golden):
    """read_batch_blob and read_batch give the JAX reader's arrays, batch
    by batch, to the end of the body."""
    from gpuar_tpu.pipeline import _PacketReader as JaxReader

    raw = np.frombuffer(_mixed_file(tmp_path / "in.bin", 0x4052,
                                    9 * P + 777), np.uint8)
    body = jax_golden.encode_stream(raw)
    for method, args in (("read_batch_blob", (max_packets, row_bytes,
                                              bucket_rows)),
                         ("read_batch", (max_packets,))):
        mine = port_pipeline._PacketReader(io.BytesIO(body), block_size=5000)
        theirs = JaxReader(io.BytesIO(body), block_size=5000)
        while True:
            a = getattr(mine, method)(*args)
            b = getattr(theirs, method)(*args)
            if a is None or a[0] is None:
                assert b is None or b[0] is None
                break
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    with pytest.raises(port_container.ContainerError, match="truncated"):
        port_pipeline._PacketReader(io.BytesIO(body[:-3])).read_batch_blob(
            8192, row_bytes, bucket_rows)


@pytest.mark.parametrize("cut", ["none", "mid_packet", "header_only"])
@pytest.mark.parametrize("deep", [False, True])
def test_verify_archive_agrees_with_jax(tmp_path, cut, deep):
    from gpuar_tpu.pipeline import HostCompressor as JaxHost
    from gpuar_tpu.pipeline import verify_archive as jax_verify

    src, gip = tmp_path / "in.bin", tmp_path / "in.gip"
    _mixed_file(src, 0x4053, 3 * P + 99)
    JaxHost().compress(src, gip)
    blob = gip.read_bytes()
    if cut == "mid_packet":
        gip.write_bytes(blob[: len(blob) - 500])
    elif cut == "header_only":
        gip.write_bytes(blob[:20])
    results = []
    for verify, error in ((port_pipeline.verify_archive,
                           port_container.ContainerError),
                          (jax_verify, ValueError)):
        try:
            results.append(verify(gip, deep=deep))
        except error as e:
            results.append(str(e))
    assert results[0] == results[1]
    assert (results[0] == {"valid": True, "packets": 4,
                           "uncompressed_size": 3 * P + 99,
                           "compressed_size": len(blob), "deep": deep}) \
        == (cut == "none")
