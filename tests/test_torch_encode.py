"""K1 wrapper (gpuar_tpu_torch.ops.encode) against the Pallas encode kernel
(interpret mode on the CPU) and the native golden codec.

On the CPU the wrapper runs the plain version; the GPU-marked tests hold
the CUDA kernel against it on the same cases.  Tolerance: 0 bytes.
"""

import functools

import numpy as np
import pytest
import torch

from gpuar_tpu import native
from gpuar_tpu_torch.ops import _kernels, encode
from gpuar_tpu_torch.ops.encode import out_geometry
from test_torch_host import CORPUS_NAMES, corpora, jax_native


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


def _random_p64(rng):
    P = 64
    data = rng.integers(0, 256, (8, P), np.uint8)
    sizes = np.full(8, P, np.int32)
    sizes[-1] = 37
    data[-1, 37:] = 0
    return data, sizes


def _classes_p128(rng):
    P = 128
    data = np.zeros((16, P), np.uint8)
    data[1] = 0xFF
    data[2] = rng.integers(0, 256, P, np.uint8)
    data[3] = np.arange(P) % 256
    data[4:] = rng.integers(0, 4, (12, P), np.uint8)
    sizes = np.full(16, P, np.int32)
    sizes[5], sizes[6] = 0, 1          # empty and 1-byte lanes
    data[5] = 0
    data[6, 1:] = 0
    return data, sizes


def _underflow_p256(rng):
    P = 256
    data = np.tile(np.array([128, 127], np.uint8), P // 2)[None].repeat(8, 0)
    data[1] = np.tile(np.array([128, 127, 128, 126], np.uint8), P // 4)
    data[2:] = rng.integers(126, 130, (6, P), np.uint8)
    return data, np.full(8, P, np.int32)


CASES = {"random_p64": _random_p64, "classes_p128": _classes_p128,
         "underflow_p256": _underflow_p256}


def adversarial_underflow_packet(n=8192):
    """Greedy adversary against the live coder state (a copy of the one in
    tests/test_pallas_encode.py): each step picks a symbol whose interval
    straddles the midpoint tightly, so the pending-underflow run grows to
    about 133 bits."""
    U16 = 0xFFFF
    C = np.arange(257, dtype=np.int64)
    lower, upper, cum, under = 0, U16, 256, 0
    syms = []
    for _ in range(n):
        span = upper - lower + 1
        lo_all = lower + C[:-1] * span // cum
        up_all = lower + C[1:] * span // cum - 1
        ok = ((lo_all >= 0x4000) & (lo_all < 0x8000)
              & (up_all >= 0x8000) & (up_all < 0xC000))
        s = int(np.argmax(ok)) if ok.any() and under < 150 else 0
        syms.append(s)
        lo2, up2 = int(lo_all[s]) & U16, int(up_all[s]) & U16
        C[s + 1:] += 1
        cum += 1
        while True:
            if (lo2 ^ up2) & 0x8000 == 0:
                under = 0
                lo2 = (lo2 << 1) & U16
                up2 = ((up2 << 1) | 1) & U16
            elif (lo2 & 0x4000) and not (up2 & 0x4000):
                under += 1
                lo2 = (lo2 << 1) & 0x7FFF
                up2 = (((up2 << 1) | 1) | 0x8000) & U16
            else:
                break
        lower, upper = lo2, up2
    return np.array(syms, np.uint8)


def assert_golden(packets, lengths, data, sizes):
    for i in range(data.shape[0]):
        assert packets[i, : lengths[i]].tobytes() == native.encode_packet(
            data[i, : sizes[i]].tobytes()), f"lane {i} (size {sizes[i]})"


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_matches_pallas(rng, case):
    from gpuar_tpu.ops import pallas_encode

    data, sizes = CASES[case](rng)
    want_pk, want_len = pallas_encode.encode_batch_pallas(
        data, sizes, tile=8, packet_size=data.shape[1], interpret=True)
    pk, ln = encode.encode_batch(torch.from_numpy(data),
                                 torch.from_numpy(sizes))
    pk, ln = pk.numpy(), ln.numpy()
    assert pk.shape == want_pk.shape
    np.testing.assert_array_equal(ln, want_len)
    for i in range(data.shape[0]):
        assert pk[i, : ln[i]].tobytes() == want_pk[i, : ln[i]].tobytes(), i
    assert_golden(pk, ln, data, sizes)


def test_encode_underflow_adversary_matches_native():
    """An unbounded pending-underflow run: the port has no run budget and
    no host fixup, so the bytes must come out right directly."""
    data = adversarial_underflow_packet()[None]
    sizes = np.full(1, 8192, np.int32)
    pk, ln = encode.encode_batch(torch.from_numpy(data),
                                 torch.from_numpy(sizes))
    assert_golden(pk.numpy(), ln.numpy(), data, sizes)


@pytest.mark.parametrize("bad", ["dtype", "sizes_shape", "sizes_dtype",
                                 "width"])
def test_encode_rejects_bad_input(bad):
    data = torch.zeros((2, 64), dtype=torch.uint8)
    sizes = torch.full((2,), 64, dtype=torch.int32)
    if bad == "dtype":
        data = data.to(torch.int32)
    elif bad == "sizes_shape":
        sizes = sizes[:1]
    elif bad == "sizes_dtype":
        sizes = sizes.to(torch.int64)
    else:
        data = torch.zeros((2, 62), dtype=torch.uint8)
    with pytest.raises(ValueError):
        encode.encode_batch(data, sizes)


# --- the kernel's arithmetic: csrc/encode.cu in numpy ---------------------

INV = np.uint64(0xFFFFFFFF) // np.arange(256, 8705, dtype=np.uint64)


class ThreadEncoder:
    """``encode_kernel``'s arithmetic for B packets at once, one per
    thread: low and high from ``QuadMirror.prefix`` and the leaf, the
    divisions by cum as ``div_by`` with the reciprocal table, ``renorm_s``,
    and ``BitWriter`` with its composed emission and long-run loop.
    ``mutant`` breaks one piece ("no_run": the pending run is dropped;
    "no_correction": the reciprocal quotient is not corrected)."""

    def __init__(self, batch, stride, mutant=None):
        self.out = np.zeros((batch, stride), np.uint8)
        self.acc = np.zeros(batch, np.uint64)
        self.n = np.zeros(batch, np.int64)
        self.pos = np.full(batch, 4, np.int64)
        self.mutant = mutant

    def put(self, v, k, on):
        """put(v, k <= 32) on the threads where ``on``."""
        v, k = np.asarray(v, np.uint64), np.asarray(k, np.uint64)
        self.acc = np.where(on, (self.acc << k) | v, self.acc)
        self.n = np.where(on, self.n + k.astype(np.int64), self.n)
        full = on & (self.n >= 32)
        self.n = np.where(full, self.n - 32, self.n)
        w = (self.acc >> self.n.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
        rows = np.nonzero(full & (self.pos + 4 <= self.out.shape[1]))[0]
        for b in range(4):   # big-endian
            self.out[rows, self.pos[rows] + b] = \
                (w[rows] >> np.uint64(24 - 8 * b)) & np.uint64(0xFF)
        self.pos = np.where(full, self.pos + 4, self.pos)

    def run(self, bit, length, on):
        length = np.where(on, length, 0)
        while length.any():
            c = np.minimum(length, 32)
            ones = (np.uint64(1) << c.astype(np.uint64)) - np.uint64(1)
            self.put(np.where(bit == 1, ones, 0), c, length > 0)
            length = length - c

    def settle(self, top, m, under, on):
        """The m settled bits, the first followed by the pending run."""
        if self.mutant == "no_run":
            under = np.zeros_like(under)
        length = np.where(m > 0, m + under, 0)
        fast = length <= 32
        r = np.where(fast & (m > 0), under, 0)
        sh = np.where(m > 0, m - 1, 0)
        self.put(top + (((1 << r) - 1) << sh), length, on & fast)
        slow = on & ~fast
        if slow.any():
            b0 = np.where(slow, top >> np.maximum(m - 1, 0), 0)
            self.put(b0, 1, slow)
            self.run(b0 ^ 1, under, slow)
            mask = (1 << np.maximum(m - 1, 0)) - 1
            self.put(top & mask, np.where(slow, m - 1, 0), slow)

    def close(self):
        rows = np.arange(len(self.n))
        while (self.n >= 8).any():
            full = self.n >= 8
            self.n = np.where(full, self.n - 8, self.n)
            byte = (self.acc >> self.n.astype(np.uint64)) & np.uint64(0xFF)
            self.out[rows[full], self.pos[full]] = byte[full]
            self.pos = np.where(full, self.pos + 1, self.pos)
        left = self.n > 0
        byte = (self.acc << (8 - self.n).astype(np.uint64)) & np.uint64(0xFF)
        self.out[rows[left], self.pos[left]] = byte[left]
        self.pos = np.where(left, self.pos + 1, self.pos)
        self.n[:] = 0

    def div_by(self, x, cum, inv):
        q = (x.astype(np.uint64) * inv) >> np.uint64(32)
        if self.mutant != "no_correction":
            q = q + (x.astype(np.uint64) - q * cum >= cum)
        return q.astype(np.int64)


def mirror_encode(data, sizes, stride, mutant=None):
    """(packets [B, stride] uint8, lengths [B]) of encode_kernel's
    arithmetic on data [B, P] with sizes [B]."""
    from test_torch_decode import QuadMirror, renorm_s

    batch = data.shape[0]
    model, enc = QuadMirror(batch), ThreadEncoder(batch, stride, mutant)
    rows = np.arange(batch)
    lo = np.zeros(batch, np.int64)
    hi = np.full(batch, 0xFFFF, np.int64)
    under = np.zeros(batch, np.int64)
    for t in range(int(sizes.max(initial=0))):
        on = t < sizes
        cum, inv = 256 + t, INV[t]
        s = data[:, t].astype(np.int64)
        low = model.prefix(s[:, None])[:, 0]
        leaf = model.l3[rows, s >> 2]
        j3 = s & 3
        high = low - np.where(j3 > 0, leaf[rows, np.maximum(j3 - 1, 0)], 0) \
            + leaf[rows, j3]
        span = hi - lo + 1
        hi2 = (lo + enc.div_by(high * span, cum, inv) - 1) & 0xFFFF
        lo2 = (lo + enc.div_by(low * span, cum, inv)) & 0xFFFF
        model.bump(s, on)
        settled = hi2
        lo2, hi2, sh, k = renorm_s(lo2, hi2)
        m = sh - k
        enc.settle(settled >> (16 - m), m, under, on)
        under = np.where(on, np.where(m > 0, k, under + k), under)
        lo, hi = np.where(on, lo2, lo), np.where(on, hi2, hi)
    tb = (lo >> 14) & 1
    every = np.ones(batch, bool)
    enc.put(tb, 1, every)
    enc.run(tb ^ 1, under + 1, every)
    enc.close()
    enc.out[:, 0] = enc.pos & 0xFF
    enc.out[:, 1] = (enc.pos >> 8) & 0xFF
    enc.out[:, 2] = sizes & 0xFF
    enc.out[:, 3] = sizes >> 8
    return enc.out, enc.pos


@functools.lru_cache(maxsize=None)
def mirror_batch():
    """Every fixture corpus cut into 8192-byte packets, then the underflow
    adversary: (data [B, 8192], sizes [B])."""
    chunks = [c[o: o + 8192] for c in (corpora()[n] for n in CORPUS_NAMES)
              for o in range(0, max(len(c), 1), 8192)]
    chunks.append(adversarial_underflow_packet().tobytes())
    data = np.zeros((len(chunks), 8192), np.uint8)
    for i, c in enumerate(chunks):
        data[i, : len(c)] = np.frombuffer(c, np.uint8)
    return data, np.array([len(c) for c in chunks], np.int64)


@functools.lru_cache(maxsize=None)
def mirrored(mutant):
    data, sizes = mirror_batch()
    return mirror_encode(data, sizes, out_geometry(8192)[1] * 4, mutant)


def test_thread_encoder_mirror_matches_golden():
    """The per-thread encoder's arithmetic equals the golden codec at 0 on
    every fixture corpus and on the underflow adversary (its ~133-bit
    pending run takes the long-run loop)."""
    data, sizes = mirror_batch()
    packets, lengths = mirrored(None)
    assert_golden(packets, lengths, data, sizes)


@pytest.mark.parametrize("mutant", ["no_run", "no_correction"])
def test_thread_encoder_mirror_catches_mutants(mutant):
    """The mirror's check has teeth: with the pending run dropped, or the
    reciprocal quotient left uncorrected, some packet differs from the
    golden codec."""
    data, sizes = mirror_batch()
    packets, lengths = mirrored(mutant)
    with pytest.raises(AssertionError):
        assert_golden(packets, lengths, data, sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES) + ["adversary_8192",
                                                  "ragged_8192"])
def test_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(11)
    if case == "adversary_8192":
        data = adversarial_underflow_packet()[None]
        sizes = np.full(1, 8192, np.int32)
    elif case == "ragged_8192":
        data = rng.integers(0, 256, (6, 8192), np.uint8)
        sizes = np.array([8192, 0, 1, 4096, 8191, 17], np.int32)
        for i, s in enumerate(sizes):
            data[i, s:] = 0
    else:
        data, sizes = CASES[case](rng)
    hold_kernel_to_plain(cuda, data, sizes)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CUDA toolkit: the build raises a clear error (nothing falls back
    to the plain version)."""
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "_BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.function("gpuar_encode")


def hold_kernel_to_plain(cuda, data, sizes):
    """K1 on the card, launched once, against the plain version on the CPU
    and the golden codec at 0."""
    d, s = torch.from_numpy(data), torch.from_numpy(sizes)
    before = _kernels.LAUNCHES["encode"]
    pk, ln = encode.encode_batch(d.to(cuda), s.to(cuda))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["encode"] == before + 1
    want_pk, want_len = encode.encode_batch(d, s)
    assert torch.equal(ln.cpu(), want_len)
    pk = pk.cpu().numpy()
    for i in range(data.shape[0]):
        assert pk[i, : want_len[i]].tobytes() == \
            want_pk[i, : want_len[i]].numpy().tobytes(), i
    assert_golden(pk, ln.cpu().numpy(), data, sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("n, p", [(1, 256), (63, 256), (64, 256), (65, 256),
                                  (4097, 256), (33, 100)])
def test_kernel_partial_blocks_match_plain(cuda, n, p):
    """Packet counts that leave a partial warp or block (64 packets a
    block): mixed contents and ragged sizes at p bytes (100: rows read 4
    bytes at a time, not 16)."""
    rng = np.random.default_rng(n + p)
    data = rng.integers(0, 256, (n, p), np.uint8)
    data[::3] = rng.integers(60, 68, (len(data[::3]), p), np.uint8)
    data[1::7] = adversarial_underflow_packet(p)
    sizes = np.full(n, p, np.int32)
    sizes[1::5] = rng.integers(0, p + 1, len(sizes[1::5]))
    for i, s in enumerate(sizes):
        data[i, s:] = 0
    hold_kernel_to_plain(cuda, data, sizes)
