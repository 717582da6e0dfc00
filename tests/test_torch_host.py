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


def _row_aligned(row_bytes: int):
    """The packets of every corpus, each at the start of a row of
    row_bytes: (the packets, their lengths, row-aligned offsets, the
    blob's bytes with two spare rows, and the back-to-back body)."""
    packets = [port_native.encode_packet(c) for blob in corpora().values()
               for c in _chunks(blob)]
    lengths = np.array([len(p) for p in packets], np.int32)
    rows = -(-lengths // row_bytes)
    offsets = np.zeros(len(packets), np.int64)
    np.cumsum(rows[:-1] * row_bytes, out=offsets[1:])
    cap = int(offsets[-1] + rows[-1] * row_bytes) + 2 * row_bytes
    return (packets, lengths, offsets, cap,
            np.frombuffer(b"".join(packets), np.uint8))


@pytest.mark.parametrize("row_bytes", [1, 96, 128])
def test_native_splice_and_expand_equal_jax(row_bytes, jax_golden):
    """splice_at strips a row-aligned blob to the body, expand_at scatters
    the body back, and splice concatenates stride rows: each equal to the
    JAX package's, on the packets of every corpus."""
    packets, lengths, offsets, cap, body = _row_aligned(row_bytes)
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


@pytest.mark.parametrize("row_bytes", [1, 96, 128])
@pytest.mark.parametrize("into", ["reused", "in_place"])
def test_native_splice_at_into_out_equals_jax(row_bytes, into, jax_golden):
    """splice_at into a given array, a reused 0xFF-filled buffer or the
    blob itself (output and sources overlapping), equals the JAX
    package's splice_at at 0 bytes, on the row-aligned blob of every
    corpus and on seeded offsets whose source ranges overlap one another;
    in place, a packet whose output would pass its source is refused."""
    _, lengths, offsets, cap, body = _row_aligned(row_bytes)
    rng = np.random.default_rng(row_bytes)
    blob = port_native.expand_at(body, offsets, lengths, cap)
    blob[offsets[-1] + lengths[-1]:] = rng.integers(
        0, 256, cap - offsets[-1] - lengths[-1], np.uint8)
    want = jax_golden.splice_at(blob, offsets, lengths)
    assert want.tobytes() == body.tobytes()
    if into == "reused":
        out = np.full(body.size + 300 * 600, 0xFF, np.uint8)
        got = port_native.splice_at(blob, offsets, lengths, out=out)
        assert got.ctypes.data == out.ctypes.data
        np.testing.assert_array_equal(got, want)
        assert (out[body.size:] == 0xFF).all()
        # Sources overlapping one another, the same out reused.
        offs = np.sort(rng.integers(0, cap - 600, 300)).astype(np.int64)
        lens = rng.integers(0, 600, 300).astype(np.int32)
        got = port_native.splice_at(blob, offs, lens, out=out)
        np.testing.assert_array_equal(
            got, jax_golden.splice_at(blob, offs, lens))
    else:
        work = blob.copy()
        got = port_native.splice_at(work, offsets, lengths, out=work)
        assert got.ctypes.data == work.ctypes.data
        np.testing.assert_array_equal(got, want)
        back = blob.copy()
        with pytest.raises(ValueError, match="past its source"):
            port_native.splice_at(back, offsets[::-1].copy(),
                                  lengths[::-1].copy(), out=back)
    with pytest.raises(ValueError, match="at least"):
        port_native.splice_at(blob, offsets, lengths,
                              out=np.empty(body.size - 1, np.uint8))


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


def _mixed_data(seed: int, size: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size, np.uint8)
    data[P: 2 * P] = 0
    data[2 * P: 3 * P] = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog. " * 200)[:P],
        np.uint8)
    return data


def _mixed_file(path, seed: int, size: int):
    data = _mixed_data(seed, size)
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


def _batches(reader, method, args, **kw):
    """Every batch a reader gives, to the end of the body."""
    out = []
    while True:
        got = getattr(reader, method)(*args, **kw)
        if got is None or got[0] is None:
            return out
        out.append(tuple(np.array(x, copy=True) for x in got))


def _assert_same_batches(mine, theirs):
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("max_packets", [1, 3, 8192])
@pytest.mark.parametrize("block_size", [100, 5000, 8 << 20])
@pytest.mark.parametrize("method", ["read_batch_blob", "read_batch"])
def test_packet_walk_equals_jax(tmp_path, method, block_size, max_packets,
                                jax_golden):
    """The native packet walk gives the JAX reader's batches, batch by
    batch, whether a packet straddles blocks of 100 B, 5000 B or none."""
    from gpuar_tpu.pipeline import _PacketReader as JaxReader

    raw = np.frombuffer(_mixed_file(tmp_path / "in.bin", 0x4054,
                                    9 * P + 777), np.uint8)
    body = jax_golden.encode_stream(raw)
    args = (max_packets, 96, 4096) if method == "read_batch_blob" \
        else (max_packets,)
    _assert_same_batches(
        _batches(port_pipeline._PacketReader(io.BytesIO(body),
                                             block_size=block_size),
                 method, args),
        _batches(JaxReader(io.BytesIO(body), block_size=block_size),
                 method, args))


@pytest.mark.parametrize("row_bytes,bucket_rows,max_packets",
                         [(96, 4096, 3), (96, 64, 2), (128, 7, 3)])
def test_packet_reader_reused_destination_equals_jax(
        tmp_path, row_bytes, bucket_rows, max_packets, jax_golden):
    """A caller's destination, filled with 0xFF and reused for every
    batch, holds blobs byte-equal to the JAX reader's zeroed ones: each
    packet's last row and the bucket's tail rows are zeroed."""
    from gpuar_tpu.pipeline import _PacketReader as JaxReader

    raw = np.frombuffer(_mixed_file(tmp_path / "in.bin", 0x4055,
                                    9 * P + 777), np.uint8)
    body = jax_golden.encode_stream(raw)
    out = np.full(port_pipeline.blob_capacity(max_packets, row_bytes,
                                              bucket_rows), 0xFF, np.uint8)
    args = (max_packets, row_bytes, bucket_rows)
    mine = _batches(port_pipeline._PacketReader(io.BytesIO(body),
                                                block_size=5000),
                    "read_batch_blob", args, out=out)
    assert len(mine) >= 3
    _assert_same_batches(
        mine, _batches(JaxReader(io.BytesIO(body), block_size=5000),
                       "read_batch_blob", args))
    with pytest.raises(ValueError, match="needs"):
        port_pipeline._PacketReader(io.BytesIO(body)).read_batch_blob(
            *args, out=out[:-1])


# --- the dense form: the packets read into the caller's buffer ------------


def _dense_body(corpus: str, jax_golden) -> bytes:
    """The JAX package's .gip body of 9 * P + 777 B: the mixed file, or
    random bytes."""
    if corpus == "mixed":
        data = _mixed_data(0x4058, 9 * P + 777)
    else:
        data = np.random.default_rng(0x4058).integers(0, 256, 9 * P + 777,
                                                      np.uint8)
    return jax_golden.encode_stream(data)


def _check_dense_batches(body: bytes, block_size: int, max_packets: int,
                         outs=None):
    """read_batch_dense against the row reader and the JAX reader, batch
    by batch to the end of the body: the same comp_len and raw_sizes,
    int64 byte offsets of back-to-back packets, and a blob that is the
    body's next bytes, ending at the last packet's last byte.  ``outs``:
    buffers handed out in turn (default: none, a new array a batch).
    Returns the number of batches."""
    from gpuar_tpu.pipeline import _PacketReader as JaxReader

    mine = port_pipeline._PacketReader(io.BytesIO(body),
                                       block_size=block_size)
    rows = port_pipeline._PacketReader(io.BytesIO(body),
                                       block_size=block_size)
    theirs = JaxReader(io.BytesIO(body), block_size=block_size)
    at = batches = 0
    while True:
        out = None if outs is None else outs[batches % len(outs)]
        got = mine.read_batch_dense(max_packets, out)
        b = rows.read_batch_blob(max_packets, 96, 64)
        c = theirs.read_batch_blob(max_packets, 96, 64)
        if got is None:
            assert b is None and c is None
            break
        blob, offsets, comp_len, raw_sizes = got
        for other in (b, c):
            np.testing.assert_array_equal(comp_len, other[2])
            np.testing.assert_array_equal(raw_sizes, other[3])
        assert offsets.dtype == np.int64 and offsets[0] == 0
        np.testing.assert_array_equal(np.diff(offsets), comp_len[:-1])
        assert blob.size == offsets[-1] + comp_len[-1]
        if out is not None:
            assert blob.ctypes.data == out.ctypes.data
        assert blob.tobytes() == body[at: at + blob.size]
        at += blob.size
        batches += 1
    assert at == len(body)
    return batches


@pytest.mark.parametrize("max_packets", [1, 3, 7, 8192])
@pytest.mark.parametrize("block_size", [100, 5000, 8 << 20])
@pytest.mark.parametrize("corpus", ["mixed", "random"])
def test_dense_reader_equals_row_and_jax_readers(corpus, block_size,
                                                 max_packets, jax_golden):
    """The dense reader gives the row reader's and the JAX reader's
    comp_len and raw_sizes batch by batch, and each packet's bytes at its
    byte offset are the file's, whether a packet straddles blocks of
    100 B, 5000 B or none and whatever the batch cuts."""
    body = _dense_body(corpus, jax_golden)
    assert _check_dense_batches(body, block_size, max_packets) \
        == -(-10 // max_packets)


@pytest.mark.parametrize("buffers", [1, 2])
@pytest.mark.parametrize("max_packets", [1, 2, 3])
def test_dense_reader_reused_destination(max_packets, buffers, jax_golden):
    """Buffers filled with 0xFF and handed out in turn, one reused for
    every batch (the carry moves within it) or two alternating (the drive
    loop's rotation), give the same batches; a buffer under
    dense_capacity is refused."""
    body = _dense_body("mixed", jax_golden)
    cap = port_pipeline._PacketReader(io.BytesIO(body), block_size=5000) \
        .dense_capacity(max_packets)
    assert cap == max_packets * 8704 + 5000
    outs = [np.full(cap, 0xFF, np.uint8) for _ in range(buffers)]
    assert _check_dense_batches(body, 5000, max_packets, outs) >= 4
    with pytest.raises(ValueError, match="needs"):
        port_pipeline._PacketReader(io.BytesIO(body)).read_batch_dense(
            max_packets, np.empty(max_packets * 8704 + (8 << 20) - 1,
                                  np.uint8))


@pytest.mark.parametrize("block", [200, 1000, 8 << 20])
def test_dense_reader_carry_across_changing_batches(tmp_path, block,
                                                    jax_golden):
    """read_batch_dense with a batch that grows and shrinks between calls,
    into two buffers in turn, at blocks that end inside 64-byte packets:
    every packet comes back once, in order, with its sizes, and the carry
    moves between batches of any size."""
    p = 64
    data = np.random.default_rng(0xCA).integers(0, 256, 61 * p + 17,
                                                np.uint8)
    data[10 * p: 30 * p] = 3
    body = jax_golden.encode_stream(data.tobytes(), packet_size=p)
    path = tmp_path / "body.bin"
    path.write_bytes(body)
    sizes = [1, 2, 5, 9, 9, 4, 2, 1]
    largest = max(sizes)
    got, raw, lens = [], [], []
    with open(path, "rb") as f:
        reader = port_pipeline._PacketReader(f, block_size=block, max_raw=p)
        outs = [np.empty(reader.dense_capacity(largest), np.uint8)
                for _ in range(2)]
        while (batch := reader.read_batch_dense(
                sizes[len(lens)] if len(lens) < len(sizes) else largest,
                outs[len(lens) % 2])) is not None:
            blob, offs, comp_len, rs = batch
            got += [blob[o: o + n].tobytes() for o, n in zip(offs, comp_len)]
            raw += rs.tolist()
            lens.append(len(rs))
    packets, at = [], 0
    while at < len(body):
        total, _ = port_container.packet_sizes(
            np.frombuffer(body[at: at + 4], np.uint8))
        packets.append(body[at: at + total])
        at += total
    assert got == packets and len(packets) == 62
    assert sum(raw) == data.size and reader.carried > 0
    assert lens == sizes + [9, 9, 9, 2]


def test_dense_reader_without_the_carry_fails(monkeypatch, jax_golden):
    """A mutant that drops the carry instead of moving it fails the dense
    reader's check (the next batch starts mid-packet)."""
    body = _dense_body("random", jax_golden)
    assert _check_dense_batches(body, 5000, 3) == 4

    def dropped(self, out):
        self._carry = (None, 0, 0)
        return 0

    monkeypatch.setattr(port_pipeline._PacketReader, "_carry_in", dropped)
    with pytest.raises((AssertionError, port_container.ContainerError)):
        _check_dense_batches(body, 5000, 3)


def test_dense_reader_keeps_the_carry_small(jax_golden):
    """On random packets of one size, the reads that finish a batch ask
    for the bytes its remaining packets hold: each batch's carry is at
    most DENSE_TAIL and a packet, and ``carried`` sums them."""
    rng = np.random.default_rng(0x4059)
    body = jax_golden.encode_stream(rng.integers(0, 256, 60 * P, np.uint8))
    reader = port_pipeline._PacketReader(io.BytesIO(body))
    bound = reader.DENSE_TAIL + 8704
    carries = []
    while reader.read_batch_dense(7) is not None:
        _, a, b = reader._carry
        assert b - a <= bound
        carries.append(b - a)
    assert len(carries) == 9 and sum(carries) == reader.carried


@pytest.mark.parametrize("block_size", [100, 8 << 20])
@pytest.mark.parametrize("fault", ["total_under_4", "total_over_8704",
                                   "raw_over_max", "cut_in_header",
                                   "cut_in_body"])
def test_dense_reader_faults_equal_the_row_reader(fault, block_size):
    """Each header fault and each cut raises the row reader's
    ContainerError, with its text, at a backend packet_size of 4096."""
    body = _faulty_body(fault)
    texts = []
    for method in ("read_batch_dense", "read_batch_blob"):
        reader = port_pipeline._PacketReader(
            io.BytesIO(body), block_size=block_size, max_raw=4096)
        args = (2,) if method == "read_batch_dense" else (2, 96, 64)
        with pytest.raises(port_container.ContainerError) as e:
            _batches(reader, method, args)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    assert ("truncated" in texts[0]) == fault.startswith("cut")


def test_header_walk_copies_nothing():
    """walk_packets with no destination writes the packets' byte offsets
    (from the buffer's start) and leaves the buffer as it was."""
    buf = np.frombuffer(port_native.encode_stream(
        np.arange(3 * P + 5, dtype=np.uint8)), np.uint8).copy()
    before = buf.copy()
    comp_len, raw_sizes = np.empty(5, np.int32), np.empty(5, np.int32)
    boff = np.full(5, -1, np.int64)
    lens = []
    at = 0
    while at < buf.size:
        lens.append(int(buf[at]) | int(buf[at + 1]) << 8)
        at += lens[-1]
    stop, n, used, rows = port_native.walk_packets(
        buf, lens[0], buf.size, 4, P, None, 0, 0, comp_len, raw_sizes, 1,
        boff=boff)
    assert (stop, n, used, rows) == (port_native.WALK_PARTIAL, 3,
                                     buf.size - lens[0], 0)
    np.testing.assert_array_equal(comp_len[1:4], lens[1:])
    np.testing.assert_array_equal(raw_sizes[1:4], [P, P, 5])
    np.testing.assert_array_equal(boff[1:4], np.cumsum(lens)[:-1])
    assert len(lens) == 4
    assert boff[0] == boff[4] == -1
    np.testing.assert_array_equal(buf, before)
    with pytest.raises(ValueError, match="needs boff"):
        port_native.walk_packets(buf, 0, buf.size, 5, P, None, 0, 0,
                                 comp_len, raw_sizes, 0)
    with pytest.raises(ValueError, match="boff"):
        port_native.walk_packets(buf, 0, buf.size, 5, P, None, 0, 0,
                                 comp_len, raw_sizes, 0,
                                 boff=np.empty(5, np.int32))


@pytest.mark.parametrize("bad", ["dst_strided", "comp_len_int64",
                                 "end_past_buf", "arrays_short"])
def test_walk_packets_rejects_bad_arguments(bad):
    """native.walk_packets checks its buffers before it passes pointers."""
    buf = np.frombuffer(port_native.encode_stream(np.zeros(3 * P, np.uint8)),
                        np.uint8).copy()
    kw = dict(buf=buf, start=0, end=buf.size, max_packets=3, max_raw=P,
              dst=np.empty(3 * 96 * 91, np.uint8), row_bytes=96, rows0=0,
              comp_len=np.empty(3, np.int32), raw_sizes=np.empty(3, np.int32),
              at=0)
    stop, n, used, rows = port_native.walk_packets(**kw)
    assert (stop, n, used) == (port_native.WALK_FULL, 3, buf.size)
    if bad == "dst_strided":
        kw["dst"] = np.empty(2 * 3 * 96 * 91, np.uint8)[::2]
    elif bad == "comp_len_int64":
        kw["comp_len"] = np.empty(3, np.int64)
    elif bad == "end_past_buf":
        kw["end"] = buf.size + 1
    else:
        kw["at"] = 1
    with pytest.raises(ValueError, match="walk_packets"):
        port_native.walk_packets(**kw)


def _faulty_body(fault: str) -> bytes:
    """Three good packets of 4096 raw bytes, then a fourth that breaks as
    the fault says (of 8192 raw bytes for "raw_over_max")."""
    rng = np.random.default_rng(0x4056)
    body = bytearray(port_native.encode_stream(
        rng.integers(0, 256, 3 * 4096, np.uint8), packet_size=4096))
    at = len(body)
    body += port_native.encode_packet(rng.integers(
        0, 256, 8192 if fault == "raw_over_max" else 4096,
        np.uint8).tobytes())
    if fault == "total_under_4":
        body[at: at + 2] = (3).to_bytes(2, "little")
    elif fault == "total_over_8704":
        body[at: at + 2] = (8705).to_bytes(2, "little")
    elif fault == "cut_in_header":
        del body[at + 2:]
    elif fault == "cut_in_body":
        del body[at + 100:]
    return bytes(body)


@pytest.mark.parametrize("block_size", [100, 8 << 20])
@pytest.mark.parametrize("method", ["read_batch_blob", "read_batch"])
@pytest.mark.parametrize("fault", ["total_under_4", "total_over_8704",
                                   "raw_over_max", "cut_in_header",
                                   "cut_in_body"])
def test_packet_reader_faults_equal_jax(fault, method, block_size):
    """Each header fault and each cut raises the JAX reader's
    ContainerError, with its text, at a backend packet_size of 4096."""
    from gpuar_tpu.container import ContainerError as JaxError
    from gpuar_tpu.pipeline import _PacketReader as JaxReader

    body = _faulty_body(fault)
    args = (2, 96, 64) if method == "read_batch_blob" else (2,)
    texts = []
    for reader, error in ((port_pipeline._PacketReader,
                           port_container.ContainerError),
                          (JaxReader, JaxError)):
        with pytest.raises(error) as e:
            _batches(reader(io.BytesIO(body), block_size=block_size,
                            max_raw=4096), method, args)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    assert ("truncated" in texts[0]) == fault.startswith("cut")


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
