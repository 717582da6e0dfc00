"""K2/K3 wrappers (gpuar_tpu_torch.ops.decode) against the Pallas decode
kernel (interpret mode on the CPU), in the stride form and in the
reader-built blob forms: the row form (96-byte rows) and the dense form
(the packets as they lie in the file, the drive loops' form).

On the CPU the wrappers run the plain version; the GPU-marked tests hold
the CUDA kernel against it on the same cases.  Tolerance: 0 bytes, and
for the debug variant equal flags.  The kernel keeps each packet's model
as a 4-ary prefix tree (csrc/packet_model.cuh, ``QuadModel``);
``QuadMirror`` repeats its arithmetic in numpy, and the CPU tests hold it,
and the kernel's division and renormalisation, to the plain version.
"""

import functools
import io

import numpy as np
import pytest
import torch

from gpuar_tpu import native
from gpuar_tpu_torch import container
from gpuar_tpu_torch.ops import _kernels, decode, torch_codec
from gpuar_tpu_torch.ops.encode import out_geometry
from gpuar_tpu_torch.pipeline import _PacketReader
from test_torch_host import CORPUS_NAMES, corpora, jax_native

HULL_P = 512   # packet size of the hull-window content classes
ROW_BYTES = 96


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


def blob_form(packets, sizes, packet_size, dense=False):
    """A reader-built form: (blob, byte offsets, comp_len) from
    _PacketReader.read_batch_blob (the row form) or, with ``dense``,
    read_batch_dense over the packets' .gip body."""
    lens = packets[:, 0].astype(np.int32) | (packets[:, 1].astype(np.int32)
                                             << 8)
    body = b"".join(packets[i, : lens[i]].tobytes() for i in range(len(lens)))
    reader = _PacketReader(io.BytesIO(body), max_raw=packet_size)
    if dense:
        blob, offs, comp_len, raw = reader.read_batch_dense(len(lens))
        np.testing.assert_array_equal(raw, sizes)
        return blob, offs, comp_len
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
    blob, offs, _ = blob_form(packets, sizes, packet_size,
                              dense=form == "dense")
    return decode.decode_blob(torch.from_numpy(blob).to(device),
                              torch.from_numpy(offs).to(device), s,
                              packet_size=packet_size, debug=debug)


@functools.lru_cache(maxsize=None)
def pallas_decoded(case):
    from gpuar_tpu.ops import pallas_decode

    data, sizes, packets = case_packets(case)
    return pallas_decode.decode_batch_pallas(
        packets, sizes, tile=8, packet_size=data.shape[1], interpret=True)


@pytest.mark.parametrize("form", ["stride", "blob", "dense"])
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
    """The message ``check`` raises (None if it passes); the JAX package's
    ContainerError and the port's are both ValueErrors."""
    try:
        check(flags, comp_len, flags.shape[1])
    except ValueError as e:
        assert check is not decode.check_debug_flags \
            or isinstance(e, container.ContainerError)
        return str(e)
    return None


@pytest.mark.parametrize("form", ["stride", "blob", "dense"])
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
@pytest.mark.parametrize("form", ["stride", "blob", "dense"])
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
@pytest.mark.parametrize("form", ["stride", "blob", "dense"])
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


# --- the kernel's arithmetic: csrc/packet_model.cuh in numpy --------------


def below(x, span, rem):
    """The search's step test x <= unscaled, asked as x * span <= rem in
    the kernel's int32 arithmetic (the products stay below 2^31)."""
    assert (x * span).max() < 2 ** 31
    return x * span <= rem


class QuadMirror:
    """``QuadModel``'s arithmetic for B packets at once: the root's S1..S3
    (r), the level-1 nodes' (l1[:, i] for node 1 + i), the level-2 nodes
    5..20 (l2) and the leaves 21..84 (l3), each {S1, S2, S3, S4}."""

    def __init__(self, batch):
        self.r = np.tile([64, 128, 192], (batch, 1))
        self.l1 = np.tile([16, 32, 48], (batch, 4, 1))
        self.l2 = np.tile([4, 8, 12, 16], (batch, 16, 1))
        self.l3 = np.tile([1, 2, 3, 4], (batch, 64, 1))
        self.rows = np.arange(batch)[:, None]

    def prefix(self, s):
        """C[s] for s [B, m] in [0, 255]: on each level, the S before s's
        child (0 for child 0) of the node over s."""
        def before(level):   # [B, nodes, 3] -> [B, 4 * nodes]
            pad = np.concatenate([np.zeros_like(level[..., :1]), level], -1)
            return pad.reshape(len(level), -1)

        v = np.take_along_axis(before(self.r[:, None, :]), s >> 6, 1)
        v += np.take_along_axis(before(self.l1), s >> 4, 1)
        v += np.take_along_axis(before(self.l2[..., :3]), s >> 2, 1)
        return v + np.take_along_axis(before(self.l3[..., :3]), s, 1)

    def bump(self, s, active):
        """Count s [B] where active, one node a level."""
        on = active[:, None]
        self.r += on * (s[:, None] < 64 * np.arange(1, 4))
        d = (s[:, None] - 64 * np.arange(4)).astype(np.uint32)[..., None]
        self.l1 += on[..., None] * (d < 16 * np.arange(1, 4))
        r = self.rows[:, 0][active]
        for level, k in ((self.l2, (s >> 2) & 3), (self.l3, s & 3)):
            node = s >> (4 if level is self.l2 else 2)
            level[r, node[active]] += (k[active, None] < np.arange(1, 5))

    def search(self, num, span):
        """(sym, low, high) for num, span [B, m]: the root and level 1 from
        registers, then the level-2 node and the leaf."""
        rem, lo = num.copy(), np.zeros_like(num)

        def step(node):
            t = [below(node[..., j], span, rem).astype(np.int64)
                 for j in range(3)]
            j = t[0] + t[1] + t[2]
            pad = np.concatenate([np.zeros_like(node[..., :1]), node], -1)
            base = np.take_along_axis(pad, j[..., None], -1)[..., 0]
            return j, base

        j0, base = step(self.r[:, None, :])
        rem, lo = rem - base * span, lo + base
        j1, base = step(self.l1[self.rows, j0])
        rem, lo = rem - base * span, lo + base
        n2 = 4 * j0 + j1
        j2, base = step(self.l2[self.rows, n2])
        rem, lo = rem - base * span, lo + base
        leaf = self.l3[self.rows, 4 * n2 + j2]
        j3, base = step(leaf)
        high = lo + np.take_along_axis(leaf, j3[..., None], -1)[..., 0]
        return 4 * (4 * n2 + j2) + j3, lo + base, high


def test_model_mirror_matches_plain_model():
    """Every fixture corpus, cut into 8192-byte packets and walked symbol
    by symbol: after each step the mirror's prefix(s) equals the plain
    version's cumulative table C[s] for every s, and its search equals the
    plain search (and low = C[sym], high = C[sym + 1]) at unscaled in {-1,
    0, cum - 1, cum, cum + 100}, each asked as num over a span."""
    chunks = [c[o: o + 8192] for c in (corpora()[n] for n in CORPUS_NAMES)
              for o in range(0, max(len(c), 1), 8192)]
    batch, steps = len(chunks), max(len(c) for c in chunks)
    data = np.zeros((batch, steps), np.int64)
    sizes = np.array([len(c) for c in chunks])
    for i, c in enumerate(chunks):
        data[i, : len(c)] = np.frombuffer(c, np.uint8)
    mirror = QuadMirror(batch)
    C, cum, lower, upper = torch_codec._initial_model(batch, "cpu")
    every = np.broadcast_to(np.arange(256), (batch, 256))
    for t in range(steps + 1):
        table = C.numpy()
        assert (mirror.prefix(every) == table[:, :256]).all(), t
        c = cum.numpy()[:, None]
        unscaled = c + np.array([-c[0, 0] - 1, -c[0, 0], -1, 0, 100])
        span = 1 + (t * 7919 + np.arange(batch)[:, None] * 104729) % 65536
        num = np.where(unscaled < 0, -span, unscaled * span
                       + (t * 31) % span)
        sym, low, high = mirror.search(num, span)
        want = torch_codec.find_symbol(
            C.repeat_interleave(5, 0), torch.from_numpy(unscaled.ravel()))
        want = want.numpy().reshape(batch, 5)
        assert (sym == want).all(), t
        assert (low == np.take_along_axis(table, want, 1)).all(), t
        assert (high == np.take_along_axis(table, want + 1, 1)).all(), t
        if t == steps:
            break
        active = t < sizes
        s = torch.from_numpy(data[:, t])
        C2, cum2, _, _ = torch_codec._apply_symbol_range(C, cum, s, lower,
                                                         upper)
        a = torch.from_numpy(active)
        C, cum = torch.where(a[:, None], C2, C), torch.where(a, cum2, cum)
        mirror.bump(data[:, t], active)


def renorm_s(lo, hi):
    """``renorm_s`` of csrc/packet_model.cuh in numpy (uint32, clz of 0 is
    32) -> (lo, hi, s, k)."""
    def clz(x):
        x = x.astype(np.uint64)
        n = np.zeros(x.shape, np.int64)
        for b in (16, 8, 4, 2, 1):
            top = (x >> np.uint64(32 - b)) == 0
            n += top * b
            x = np.where(top, x << np.uint64(b), x) & np.uint64(0xFFFFFFFF)
        return n + (x == 0)

    m = clz(lo ^ hi) - 16
    x = (((lo & ~hi & 0xFFFF) << 16) << (m + 1)) & 0xFFFFFFFF
    k = clz(~x & 0xFFFFFFFF)
    s = m + k
    return ((lo << s) & 0x7FFF, ((hi << s) | ((1 << s) - 1) | 0x8000)
            & 0xFFFF, s, k)


def test_renorm_s_matches_plain_renorm():
    """renorm_s against the plain version's renormalisation on every pair
    of a set of edge values and on a million random pairs, inverted pairs
    (corrupt streams) included."""
    edges = np.unique(np.concatenate([
        [0, 1, 0x3FFF, 0x4000, 0x4001, 0x7FFE, 0x7FFF, 0x8000, 0x8001,
         0xBFFF, 0xC000, 0xFFFE, 0xFFFF],
        (1 << np.arange(16)), (1 << np.arange(16)) - 1,
        0xFFFF ^ ((1 << np.arange(16)) - 1)]))
    rng = np.random.default_rng(0x5E)
    lo = np.concatenate([np.repeat(edges, len(edges)),
                         rng.integers(0, 1 << 16, 1 << 20)])
    hi = np.concatenate([np.tile(edges, len(edges)),
                         rng.integers(0, 1 << 16, 1 << 20)])
    got = renorm_s(lo.astype(np.int64), hi.astype(np.int64))
    lo2, hi2, m, k = torch_codec._renorm(torch.from_numpy(lo),
                                         torch.from_numpy(hi))
    for a, b in zip(got, (lo2, hi2, m + k, k)):
        np.testing.assert_array_equal(a, b.numpy())


def test_div_by_reciprocal_is_exact():
    """div_by: floor(x * inv / 2^32) plus one correction, inv =
    floor((2^32 - 1) / cum), equals x // cum for every cum of the table
    (256 .. 8704) at the edges of each quotient and at random x < 2^31."""
    cum = np.arange(256, 8705, dtype=np.uint64)[:, None]
    inv = np.uint64(0xFFFFFFFF) // cum
    rng = np.random.default_rng(0xD1)
    q = np.concatenate([np.zeros((len(cum), 1), np.uint64),
                        rng.integers(1, (2 ** 31 - 1) // 8704, (len(cum), 8),
                                     dtype=np.uint64),
                        (np.uint64(2 ** 31 - 1) // cum) - np.uint64(1)], 1)
    x = np.concatenate([q * cum, q * cum + cum - np.uint64(1),
                        rng.integers(0, 2 ** 31, (len(cum), 8),
                                     dtype=np.uint64)], 1)
    got = (x * inv) >> np.uint64(32)
    got = got + (x - got * cum >= cum)
    np.testing.assert_array_equal(got, x // cum)


# --- GPU: K2/K3 at partial blocks and on edge packets ---------------------


def golden_batch(data, sizes, packet_size):
    """(blob, byte offsets, comp_len, raw sizes) of golden-encoded packets,
    as the reader builds them."""
    packets = golden_stride(data, sizes, out_geometry(packet_size)[1] * 4)
    blob, offs, comp_len = blob_form(packets, sizes, packet_size)
    return blob, offs, comp_len


def hold_to_plain(cuda, blob, offs, sizes, packet_size, data=None):
    """K2 and K3 on the card against the plain version on the CPU (and the
    data, where given) at 0; -> K3's flags."""
    args = [torch.from_numpy(x) for x in (blob, offs, sizes)]
    out = decode.decode_blob(*(a.to(cuda) for a in args),
                             packet_size=packet_size)
    raw, flags = decode.decode_blob(*(a.to(cuda) for a in args),
                                    packet_size=packet_size, debug=True)
    want_raw, want_flags = decode.decode_blob(*args, packet_size=packet_size,
                                              debug=True)
    np.testing.assert_array_equal(out.cpu().numpy(), want_raw.numpy())
    np.testing.assert_array_equal(raw.cpu().numpy(), want_raw.numpy())
    np.testing.assert_array_equal(flags.cpu().numpy(), want_flags.numpy())
    if data is not None:
        np.testing.assert_array_equal(out.cpu().numpy(), data)
    return flags.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("n, p", [(1, 256), (31, 256), (33, 256), (65, 256),
                                  (4097, 256), (33, 102)])
def test_kernel_partial_blocks_match_plain(cuda, n, p):
    """Packet counts that leave a partial warp or block (64 packets a
    block): mixed contents and ragged sizes at p bytes (102: rows that
    are not whole 32-bit words, stored byte by byte)."""
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (n, p), np.uint8)
    data[::3] = rng.integers(60, 68, (len(data[::3]), p), np.uint8)
    sizes = np.full(n, p, np.int32)
    sizes[1::5] = rng.integers(0, p + 1, len(sizes[1::5]))
    for i, s in enumerate(sizes):
        data[i, s:] = 0
    blob, offs, comp_len = golden_batch(data, sizes, p)
    flags = hold_to_plain(cuda, blob, offs, sizes, p, data)
    decode.check_debug_flags(flags, comp_len, n)


def edge_batch(dense=False):
    """Full-size packets at the search's and the coder's edges: one
    repeated symbol (0x00, 0xFF: the descent's two ends), raw sizes 0, 1
    and 8191, the underflow adversary; then noise-bodied copies of the
    compressible ones.  -> (data, sizes, blob, offs, comp_len, n_clean),
    the blob in the row form or, with ``dense``, the dense form."""
    from test_torch_encode import adversarial_underflow_packet

    P = 8192
    rng = np.random.default_rng(0xED6E)
    data = np.zeros((6, P), np.uint8)
    data[1] = 0xFF
    data[3, 0] = 0x7F
    data[4] = rng.integers(0, 256, P, np.uint8)
    data[5] = adversarial_underflow_packet(P)
    sizes = np.array([P, P, 0, 1, P - 1, P], np.int32)
    data[4, P - 1] = 0
    packets = golden_stride(data, sizes, out_geometry(P)[1] * 4)
    lens = packets[:, 0].astype(np.int32) | (packets[:, 1].astype(np.int32)
                                             << 8)
    noisy = packets[[0, 1, 5]].copy()
    for row, i in zip(noisy, (0, 1, 5)):
        row[4: lens[i]] = rng.integers(0, 256, lens[i] - 4, np.uint8)
    all_pk = np.concatenate([packets, noisy])
    all_sizes = np.concatenate([sizes, sizes[[0, 1, 5]]])
    blob, offs, comp_len = blob_form(all_pk, all_sizes, P, dense)
    return data, all_sizes, blob, offs, comp_len, len(sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["rows", "dense"])
def test_kernel_edge_packets_match_plain(cuda, form):
    """K3 flags exactly the corrupt well-framed packets in either blob
    form (in the dense form a packet's lookahead reads its neighbour's
    bytes, not zeros)."""
    data, sizes, blob, offs, comp_len, n = edge_batch(form == "dense")
    flags = hold_to_plain(cuda, blob, offs, sizes, 8192)
    raw = decode.decode_blob(*(torch.from_numpy(x).to(cuda)
                               for x in (blob, offs, sizes)))
    np.testing.assert_array_equal(raw[:n].cpu().numpy(), data)
    # K3 raises for exactly the noise-bodied packets.
    with pytest.raises(container.ContainerError) as info:
        decode.check_debug_flags(flags, comp_len, len(sizes))
    assert str(info.value).endswith(f"packets {list(range(n, len(sizes)))}")
    decode.check_debug_flags(flags[:, :n], comp_len[:n], n)


def _card_batch_body(n: int, rng):
    """n full packets of mixed contents, the last ragged, as a .gip body
    behind three packets of another batch -> (data [n, 8192], sizes,
    body)."""
    P = 8192
    data = rng.integers(0, 256, (n, P), np.uint8)
    data[1::4] = rng.integers(60, 68, (len(data[1::4]), P), np.uint8)
    data[2::4] = 0
    sizes = np.full(n, P, np.int32)
    sizes[-1] = 4000
    data[-1, 4000:] = 0
    head = rng.integers(0, 256, 3 * P, np.uint8)
    body = native.encode_stream(np.concatenate([head, data.reshape(-1)[
        : (n - 1) * P + 4000]]))
    return data, sizes, body


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 63, 4097, 4224])
def test_dense_kernel_matches_row_blob_and_plain(cuda, n):
    """K2 and K3 on a dense blob of n packets (4224: the H100's batch)
    equal them on the row blob of the same packets and the plain version
    on the card at 0, and the data.  The dense batch is read behind a
    batch of three packets at a block of 50,001 B: its first packets came
    over as the carry, the last of them cut by the block's end."""
    from gpuar_tpu_torch.ops.encode import out_geometry as geometry

    data, sizes, body = _card_batch_body(n, np.random.default_rng(n))
    reader = _PacketReader(io.BytesIO(body), block_size=50_001)
    assert len(reader.read_batch_dense(3)[1]) == 3
    assert reader.carried == 0
    blob, offs, comp_len, raw = reader.read_batch_dense(n)
    assert reader.carried > 0 and len(raw) == n
    assert reader.read_batch_dense(n) is None
    np.testing.assert_array_equal(raw, sizes)
    rows = _PacketReader(io.BytesIO(body))
    rows.read_batch_blob(3, ROW_BYTES, 64)
    rblob, roff, _, _ = rows.read_batch_blob(n, ROW_BYTES, 64)
    dense = [torch.from_numpy(x).to(cuda) for x in (blob, offs, raw)]
    row = [torch.from_numpy(x).to(cuda)
           for x in (rblob, roff.astype(np.int64) * ROW_BYTES, raw)]
    out = decode.decode_blob(*dense)
    dbg, flags = decode.decode_blob(*dense, debug=True)
    want = decode.decode_blob(*row)
    want_dbg, want_flags = decode.decode_blob(*row, debug=True)
    stride = geometry(8192)[1] * 4
    plain, plain_flags = torch_codec.decode_packets(
        torch_codec.gather_regions(dense[0], dense[1], stride), dense[2],
        8192, debug=True)
    for got in (out, dbg, want, want_dbg):
        assert torch.equal(got, plain)
    assert torch.equal(flags, want_flags) and torch.equal(flags, plain_flags)
    np.testing.assert_array_equal(out.cpu().numpy(), data)
    decode.check_debug_flags(flags.cpu().numpy(), comp_len, n)
