"""K1 wrapper (gpuar_tpu_torch.ops.encode) against the Pallas encode kernel
(interpret mode on the CPU) and the native golden codec.

On the CPU the wrapper runs the plain version; the GPU-marked tests hold
the CUDA kernel against it on the same cases.  Tolerance: 0 bytes.
"""

import numpy as np
import pytest
import torch

from gpuar_tpu import native
from gpuar_tpu_torch.ops import _kernels, encode


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


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CUDA toolkit: the build raises a clear error (nothing falls back
    to the plain version)."""
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "library_path",
                        lambda: tmp_path / "libgpuar_kernels_test.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
