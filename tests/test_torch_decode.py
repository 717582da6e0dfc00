"""K2/K3 wrappers (gpuar_tpu_torch.ops.decode) against the Pallas decode
kernel (interpret mode on the CPU), in the stride form and in the
reader-built blob form.

On the CPU the wrappers run the plain version; the GPU-marked tests hold
the CUDA kernel against it on the same cases.  Tolerance: 0 bytes, and
for the debug variant equal flags.
"""

import functools
import io

import numpy as np
import pytest
import torch

from gpuar_tpu import container, native
from gpuar_tpu.pipeline import _PacketReader
from gpuar_tpu_torch.ops import _kernels, decode
from gpuar_tpu_torch.ops.encode import out_geometry

HULL_P = 512   # packet size of the hull-window content classes
ROW_BYTES = 96


@pytest.fixture
def cuda():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def golden_stride(data, sizes, stride):
    """Golden-encoded packets laid out at a fixed stride."""
    packets = np.zeros((data.shape[0], stride), np.uint8)
    for i in range(data.shape[0]):
        e = native.encode_packet(data[i, : sizes[i]].tobytes())
        packets[i, : len(e)] = np.frombuffer(e, np.uint8)
    return packets


def _random_p64(rng):
    data = rng.integers(0, 256, (8, 64), np.uint8)
    sizes = np.full(8, 64, np.int32)
    sizes[3], sizes[5] = 17, 0
    return data, sizes


def _classes_p128(rng):
    P = 128
    data = np.zeros((8, P), np.uint8)
    data[1] = 0xFF
    data[2] = rng.integers(0, 256, P, np.uint8)
    data[3] = np.arange(P) % 256
    data[4:] = rng.integers(126, 130, (4, P), np.uint8)
    return data, np.full(8, P, np.int32)


def _ascii_then_binary(rng):
    data = np.zeros((8, HULL_P), np.uint8)
    data[:, : HULL_P // 2] = rng.integers(32, 127, (8, HULL_P // 2))
    data[:, HULL_P // 2:] = rng.integers(0, 256, (8, HULL_P // 2))
    return data, np.full(8, HULL_P, np.int32)


def _binary_then_ascii(rng):
    data = np.zeros((8, HULL_P), np.uint8)
    data[:, : HULL_P // 2] = rng.integers(128, 256, (8, HULL_P // 2))
    data[:, HULL_P // 2:] = rng.integers(32, 127, (8, HULL_P // 2))
    return data, np.full(8, HULL_P, np.int32)


def _single_high_byte(rng):
    data = rng.integers(32, 127, (8, HULL_P), np.uint8)
    data[3, 300] = 200
    return data, np.full(8, HULL_P, np.int32)


def _symbols_127_128(rng):
    data = np.full((8, HULL_P), 127, np.uint8)
    data[1, ::7] = 128
    data[2] = rng.integers(120, 136, HULL_P, np.uint8)
    data[3, 256:] = 128
    data[4:] = rng.integers(126, 130, (4, HULL_P), np.uint8)
    return data, np.full(8, HULL_P, np.int32)


def _ragged_tails(rng):
    sizes = np.asarray([HULL_P, 1, 100, 257, HULL_P - 1, 0, 33, 480],
                       np.int32)
    data = np.zeros((8, HULL_P), np.uint8)
    for i, n in enumerate(sizes):
        data[i, :n] = rng.integers(32, 127, n, np.uint8)
    data[4, : sizes[4]] = rng.integers(0, 256, sizes[4], np.uint8)
    return data, sizes


CASES = {f.__name__[1:]: f for f in (
    _random_p64, _classes_p128, _ascii_then_binary, _binary_then_ascii,
    _single_high_byte, _symbols_127_128, _ragged_tails)}


@functools.lru_cache(maxsize=None)
def case_packets(case):
    """(data, sizes, golden packets at the kernel stride) of a case."""
    data, sizes = CASES[case](np.random.default_rng(0xDEC0DE))
    for i, s in enumerate(sizes):
        data[i, s:] = 0
    stride = out_geometry(data.shape[1])[1] * 4
    return data, sizes, golden_stride(data, sizes, stride)


def blob_form(packets, sizes, packet_size):
    """The reader-built form: (blob, byte offsets, comp_len) from
    _PacketReader.read_batch_blob over the packets' .gip body."""
    lens = packets[:, 0].astype(np.int32) | (packets[:, 1].astype(np.int32)
                                             << 8)
    body = b"".join(packets[i, : lens[i]].tobytes() for i in range(len(lens)))
    reader = _PacketReader(io.BytesIO(body), max_raw=packet_size)
    blob, roff, comp_len, raw = reader.read_batch_blob(len(lens), ROW_BYTES,
                                                       64)
    np.testing.assert_array_equal(raw, sizes)
    return blob, roff.astype(np.int64) * ROW_BYTES, comp_len


def port_decode(form, packets, sizes, packet_size, device="cpu",
                debug=False):
    s = torch.from_numpy(sizes).to(device)
    if form == "stride":
        return decode.decode_batch(torch.from_numpy(packets).to(device), s,
                                   packet_size=packet_size, debug=debug)
    blob, offs, _ = blob_form(packets, sizes, packet_size)
    return decode.decode_blob(torch.from_numpy(blob).to(device),
                              torch.from_numpy(offs).to(device), s,
                              packet_size=packet_size, debug=debug)


@functools.lru_cache(maxsize=None)
def pallas_decoded(case):
    from gpuar_tpu.ops import pallas_decode

    data, sizes, packets = case_packets(case)
    return pallas_decode.decode_batch_pallas(
        packets, sizes, tile=8, packet_size=data.shape[1], interpret=True)


@pytest.mark.parametrize("form", ["stride", "blob"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_pallas(case, form):
    data, sizes, packets = case_packets(case)
    want = pallas_decoded(case)
    np.testing.assert_array_equal(want, data)   # zero past raw_size
    got = port_decode(form, packets, sizes, data.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)


# --- debug decode (K3): the cases of tests/test_debug_asserts.py ---------

DEBUG_P = 512


@functools.lru_cache(maxsize=None)
def debug_batch():
    """(packets, comp_len, sizes, clean mask): four clean packets, then
    copies of the three compressible ones whose bitstream is replaced by
    noise under an intact frame, then two random bit strings framed as
    packets."""
    rng = np.random.default_rng(0xDEB6)
    data = np.zeros((4, DEBUG_P), np.uint8)
    data[0] = rng.integers(0, 256, DEBUG_P, np.uint8)
    data[2] = rng.integers(126, 130, DEBUG_P, np.uint8)
    data[3, :256] = 65
    stride = out_geometry(DEBUG_P)[1] * 4
    clean = golden_stride(data, np.full(4, DEBUG_P, np.int32), stride)
    lens = clean[:, 0].astype(np.int32) | (clean[:, 1].astype(np.int32) << 8)
    noisy = clean[1:].copy()   # the compressible ones: noise overruns
    for i in range(3):
        noisy[i, 4: lens[i + 1]] = rng.integers(0, 256, lens[i + 1] - 4,
                                                np.uint8)
    framed = np.zeros((2, stride), np.uint8)
    framed[:, 0], framed[:, 1] = 204 & 0xFF, 204 >> 8
    framed[:, 2], framed[:, 3] = DEBUG_P & 0xFF, DEBUG_P >> 8
    framed[:, 4:204] = rng.integers(0, 256, (2, 200), np.uint8)
    packets = np.concatenate([clean, noisy, framed])
    comp_len = packets[:, 0].astype(np.int64) | (packets[:, 1].astype(
        np.int64) << 8)
    is_clean = np.array([True] * 4 + [False] * 5)
    return packets, comp_len, np.full(9, DEBUG_P, np.int32), is_clean


@functools.lru_cache(maxsize=None)
def pallas_debug_flags():
    import jax.numpy as jnp

    from gpuar_tpu.ops import pallas_decode

    packets, _, sizes, _ = debug_batch()
    og, ow = out_geometry(DEBUG_P)
    p32, n_pad = pallas_decode.pad_packets32(packets, 8, ow)
    sz = np.zeros((1, n_pad), np.int32)
    sz[0, : len(sizes)] = sizes
    out, flags = pallas_decode._decode_call(
        jnp.asarray(p32), jnp.asarray(sz), tile=8, packet_size=DEBUG_P,
        out_groups=og, interpret=True, debug=True)
    raw = np.ascontiguousarray(np.asarray(out)).view(np.uint8)
    return raw[: len(sizes), :DEBUG_P], np.asarray(flags)[:, : len(sizes)]


def raised_packets(check, flags, comp_len):
    try:
        check(flags, comp_len, flags.shape[1])
    except container.ContainerError as e:
        return str(e)
    return None


@pytest.mark.parametrize("form", ["stride", "blob"])
def test_debug_flags_match_pallas(form):
    from gpuar_tpu.ops import pallas_decode

    packets, comp_len, sizes, is_clean = debug_batch()
    want_raw, want = pallas_debug_flags()
    raw, flags = port_decode(form, packets, sizes, DEBUG_P, debug=True)
    flags = flags.numpy()
    np.testing.assert_array_equal(flags[0], want[0])
    np.testing.assert_array_equal(flags[1, is_clean], want[1, is_clean])
    np.testing.assert_array_equal(raw.numpy()[is_clean], want_raw[is_clean])
    port_msg = raised_packets(decode.check_debug_flags, flags, comp_len)
    assert port_msg is not None and port_msg.endswith("packets [4, 5, 6, 7, 8]")
    assert port_msg == raised_packets(pallas_decode.check_debug_flags, want,
                                      comp_len)
    # The clean packets alone pass.
    decode.check_debug_flags(flags[:, is_clean], comp_len[is_clean],
                             int(is_clean.sum()))


def test_coder_invariants_hold_for_arbitrary_streams():
    """Random bit strings framed as packets never trip the invariant flags
    (row 0): arithmetic decoding maps every stream to some symbols."""
    packets, _, sizes, _ = debug_batch()
    _, flags = port_decode("stride", packets[-2:], sizes[-2:], DEBUG_P,
                           debug=True)
    assert not flags.numpy()[0].any()


def test_check_debug_flags_matches_pallas_rule():
    from gpuar_tpu.ops import pallas_decode

    comp_len = np.array([100, 100, 100, 100, 100, 100, 100, 100, 100, 100])
    flags = np.zeros((2, 10), np.int32)
    flags[1] = 100 * 8 + 16
    assert raised_packets(decode.check_debug_flags, flags, comp_len) is None
    flags[1, 3] += 1
    flags[0, [1, 2, 4, 5, 6, 7, 8, 9]] = 1
    msg = raised_packets(decode.check_debug_flags, flags, comp_len)
    assert msg == raised_packets(pallas_decode.check_debug_flags, flags,
                                 comp_len)
    assert msg.endswith("packets [1, 2, 3, 4, 5, 6, 7, 8]...")


@pytest.mark.parametrize("bad", ["dtype", "sizes", "offsets"])
def test_decode_rejects_bad_input(bad):
    packets = torch.zeros((2, 96), dtype=torch.uint8)
    sizes = torch.zeros(2, dtype=torch.int32)
    offs = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        if bad == "dtype":
            decode.decode_batch(packets.to(torch.int32), sizes)
        elif bad == "sizes":
            decode.decode_batch(packets, sizes[:1])
        else:
            decode.decode_blob(packets.view(-1), offs.to(torch.int32), sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["stride", "blob"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, case, form):
    data, sizes, packets = case_packets(case)
    before = _kernels.LAUNCHES["decode"]
    got = port_decode(form, packets, sizes, data.shape[1], device=cuda)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["decode"] == before + 1
    want = port_decode(form, packets, sizes, data.shape[1])
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), data)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["stride", "blob"])
def test_debug_kernel_matches_plain(cuda, form):
    packets, comp_len, sizes, is_clean = debug_batch()
    before = _kernels.LAUNCHES["decode_debug"]
    raw, flags = port_decode(form, packets, sizes, DEBUG_P, device=cuda,
                             debug=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["decode_debug"] == before + 1
    want_raw, want = port_decode(form, packets, sizes, DEBUG_P, debug=True)
    np.testing.assert_array_equal(flags.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(raw.cpu().numpy(), want_raw.numpy())
