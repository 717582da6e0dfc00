"""P1–P4 (``gpuar_tpu_torch.probes``) against the TPU probes of
``benchmarks/``.

On the CPU each probe's plain PyTorch version is held at 0 to the Pallas
body of the TPU probe, run in interpret mode with the probe's own specs
(``probe_model.make`` with ``run``'s specs, ``run_carry``'s kernel,
``profile_encode.call``, ``probe_layouts.call``) and its module globals set
small.  P1's ``v11_unroll4``, ``v16_unroll4_3pass`` and
``v17_unroll4_stale`` read one input row per step; the TPU probe gives
them STEPS/4 rows, so their TPU output is undefined, and here both sides
get [STEPS, TILE].  P3 is compared on ``len`` at every level: the TPU's
ring and dump have no counterpart in the port, so the stored words are
compared only between the kernel and its plain version, on the card.

The GPU-marked tests hold each kernel to its plain version at 0 on the
card and skip here.
"""

import functools
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gpuar_tpu_torch.ops.torch_codec import _clz16
from gpuar_tpu_torch.probes import probe_layouts, probe_model, profile_encode

REPO = Path(__file__).resolve().parent.parent
TILE, STEPS, REPEAT = 8, 32, 2


@functools.lru_cache(maxsize=None)
def tpu():
    """JAX, Pallas and the TPU probe modules of ``benchmarks/``, imported
    where a CPU test runs (the card's machine has no JAX)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    sys.path.insert(0, str(REPO / "benchmarks"))
    import probe_layouts as layouts
    import probe_model as model
    import profile_encode as encode

    return types.SimpleNamespace(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu,
                                 pallas_call=pl.pallas_call, model=model,
                                 encode=encode, layouts=layouts)


@pytest.fixture
def small_model(monkeypatch):
    for name, value in (("TILE", TILE), ("STEPS", STEPS),
                        ("REPEAT", REPEAT)):
        monkeypatch.setattr(tpu().model, name, value)


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call of the TPU probes runs in interpret mode."""
    t = tpu()
    monkeypatch.setattr(t.pl, "pallas_call",
                        functools.partial(t.pallas_call, interpret=True))


@pytest.fixture
def cuda():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tpu_model(variant, words):
    t = tpu()
    kernel, rows, dtype = t.model.make(variant)
    out = t.pallas_call(
        kernel,
        out_shape=t.jax.ShapeDtypeStruct((1, TILE), t.jnp.int32),
        in_specs=[t.pl.BlockSpec(memory_space=t.pltpu.VMEM)],
        out_specs=t.pl.BlockSpec(memory_space=t.pltpu.VMEM),
        scratch_shapes=[t.pltpu.VMEM((rows, TILE), dtype)],
        interpret=True,
    )(t.jnp.asarray(words))
    return np.asarray(out)[0]


@pytest.mark.parametrize("variant", probe_model.VARIANTS)
def test_p1_plain_equals_pallas_body(variant, small_model):
    words = probe_model.make_words(probe_model.input_rows(variant, STEPS),
                                   TILE, seed=3)
    want = _tpu_model(variant, words)
    got = probe_model.model(torch.from_numpy(words), variant, STEPS, REPEAT)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def i16_wrap_words(tile: int, seed: int = 11) -> tuple[int, np.ndarray]:
    """(steps, words [steps/4, tile]): enough steps that row 255's int16
    count (255 plus one for each symbol below 255) passes 32,767 on every
    chain."""
    steps = 34816
    words = probe_model.make_words(steps // 4, tile, seed)
    below = (words.view(np.uint8).reshape(steps // 4, tile, 4) < 255)
    assert (255 + below.sum((0, 2)) > 32767).all()
    return steps, words


@pytest.mark.parametrize("variant", ("v31_i16_3pass", "v32_i16_mixed"))
def test_p1_i16_counts_wrap_as_pallas_body(variant, monkeypatch):
    """The int16 counts wrap as the TPU's do: the full probe's 65,536
    steps take them past 32,767, which the small STEPS above never do."""
    steps, words = i16_wrap_words(TILE)
    for name, value in (("TILE", TILE), ("STEPS", steps), ("REPEAT", 1)):
        monkeypatch.setattr(tpu().model, name, value)
    want = _tpu_model(variant, words)
    got = probe_model.model(torch.from_numpy(words), variant, steps, 1)
    np.testing.assert_array_equal(got.numpy(), want)


class _Captured(Exception):
    pass


def _tpu_carry_kernel(monkeypatch, config):
    """run_carry's kernel and its pallas_call arguments, captured at the
    probe's own call site (run_carry times the call, so it is stopped
    there)."""
    def capture(kernel, **kwargs):
        raise _Captured(kernel, kwargs)

    t = tpu()
    monkeypatch.setattr(t.pl, "pallas_call", capture)
    ncarry, packed, unroll = probe_model.CARRIES[config]
    with pytest.raises(_Captured) as exc:
        t.model.run_carry(config, ncarry, packed, unroll=unroll)
    monkeypatch.setattr(t.pl, "pallas_call", t.pallas_call)
    return exc.value.args


@pytest.mark.parametrize("config", list(probe_model.CARRIES))
def test_p2_plain_equals_pallas_body(config, small_model, monkeypatch):
    kernel, kwargs = _tpu_carry_kernel(monkeypatch, config)
    words = probe_model.make_words(STEPS // 4, TILE)
    want = np.asarray(tpu().pallas_call(kernel, interpret=True, **kwargs)(
        tpu().jnp.asarray(words)))[0]
    got = probe_model.carry(torch.from_numpy(words), config, STEPS * REPEAT)
    np.testing.assert_array_equal(got.numpy(), want)


def p3_inputs(n: int, steps: int, seed: int = 5):
    """words int32 [steps/4, n] and sizes int32 [n]: random packets, a
    zero run, the smoke's underflow adversary (runs of whole fill words
    at level 5), and sizes from 0 to steps."""
    from chip_smoke import adversarial_underflow_packet

    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n, steps), np.uint8)
    data[1] = 0
    data[2] = adversarial_underflow_packet(steps)
    words = np.ascontiguousarray(data.view("<i4").T)
    sizes = np.full(n, steps, np.int32)
    sizes[3], sizes[4], sizes[5] = 0, 1, steps // 2 + 3
    return words, sizes


@pytest.mark.parametrize("level", profile_encode.LEVELS)
def test_p3_len_equals_pallas_body(level, interpret):
    n, steps, tile = 16, 64, 8
    words, sizes = p3_inputs(n, steps)
    jnp = tpu().jnp
    _, want = tpu().encode.call(level, tile, steps, 8, jnp.asarray(words),
                                jnp.asarray(sizes[None, :]))
    out, got = profile_encode.profile(torch.from_numpy(words),
                                      torch.from_numpy(sizes), level, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    assert out.shape == (n, profile_encode.out_geometry(steps)[1])
    assert bool((out != 0).any()) == (level >= 4)


def test_p3_level5_stores_whole_fill_words():
    """Level 5 adds only the underflow runs' whole fill words to level 4's
    stores, at their place in the stream; the adversary has such runs."""
    steps = 256
    words, sizes = p3_inputs(8, steps)
    w, s = torch.from_numpy(words), torch.from_numpy(sizes)
    out4, len4 = profile_encode.profile(w, s, 4, steps)
    out5, len5 = profile_encode.profile(w, s, 5, steps)
    assert torch.equal(len4, len5)
    differs = (out4 != out5).any(1)
    assert bool(differs[2]) and not bool(differs[0])
    assert set(out5[out4 != out5].tolist()) <= {0, -1}


@pytest.mark.parametrize("probe", probe_layouts.PROBES)
def test_p4_plain_equals_pallas_body(probe, interpret, monkeypatch):
    t = tpu()
    n = 128 if probe == "k_onehot" else 16
    monkeypatch.setattr(t.layouts, "STEPS", STEPS)
    monkeypatch.setattr(t.layouts, "B", n)
    kernel = getattr(t.layouts, probe)
    if probe in probe_layouts.SCALAR:
        want = t.layouts.call(kernel)
        got = probe_layouts.scalar(torch.from_numpy(probe_layouts.make_seed()),
                                   probe, STEPS)
    else:
        shape = (256, n) if probe == "k_onehot" else (n, 256)
        want = t.layouts.call(kernel,
                              scratch=[t.pltpu.VMEM(shape, t.jnp.int32)])
        got = probe_layouts.table(torch.zeros(1, dtype=torch.int32), probe,
                                  n, STEPS)
    np.testing.assert_array_equal(
        probe_layouts.tpu_output(probe, got).numpy(), np.asarray(want))


def test_f32_tricks_equal_native_ops():
    """The float32 shift and clz tricks equal the native operations on
    every operand the probes give them."""
    x = torch.arange(1 << 16, dtype=torch.int32)
    for m in range(16):
        mm = torch.full_like(x, m)
        np.testing.assert_array_equal(probe_layouts._shl16(x, mm),
                                      (x << m) & 0xFFFF)
        np.testing.assert_array_equal(probe_layouts._shr(x, 16 - mm),
                                      x >> (16 - m))
    np.testing.assert_array_equal(probe_layouts._clz16f(x | 1),
                                  _clz16(x | 1))
    # The 32-bit clz of v14 and k_clz, on their operands (below 2**24).
    q = torch.tensor([0, 1, 2, 255, 256, 65535, (1 << 24) - 1],
                     dtype=torch.int32)
    np.testing.assert_array_equal(_clz16(q) + 16,
                                  [32, 31, 30, 24, 23, 16, 8])


def test_wrappers_check_their_inputs():
    words = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown variant"):
        probe_model.model(words, "v99", steps=4, repeat=1)
    with pytest.raises(ValueError, match="rows"):
        probe_model.model(words, "v11_unroll4", steps=16, repeat=1)
    with pytest.raises(ValueError, match="int32"):
        probe_model.model(words.to(torch.int64), "v0_3pass_256", 4, 1)
    with pytest.raises(ValueError, match="level"):
        profile_encode.profile(words, torch.zeros(8, dtype=torch.int32), 6,
                               steps=16)
    with pytest.raises(ValueError, match="unknown scalar"):
        probe_layouts.scalar(words, "k_onehot", 4)
    with pytest.raises(ValueError, match="unknown table"):
        probe_layouts.table(words, "k_base", 4, 4)


def test_probe_entry_point_refuses_without_a_card(monkeypatch):
    from gpuar_tpu_torch.probes import __main__ as entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        entry.main(["layouts"])
    with pytest.raises(SystemExit):
        entry.main(["nonsense"])


# --- On the card: each kernel against its plain version at 0. ------------

@pytest.mark.gpu
@pytest.mark.parametrize("variant", probe_model.VARIANTS)
def test_p1_kernel_equals_plain(variant, cuda):
    steps, repeat, tile = 160, 2, 100
    words = torch.from_numpy(probe_model.make_words(
        probe_model.input_rows(variant, steps), tile, seed=7)).to(cuda)
    got = probe_model.model(words, variant, steps, repeat)
    want = probe_model.model_plain(words, variant, steps, repeat)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ("v31_i16_3pass", "v32_i16_mixed"))
def test_p1_i16_wrap_kernel_equals_plain(variant, cuda):
    steps, words = i16_wrap_words(64)
    w = torch.from_numpy(words).to(cuda)
    assert torch.equal(probe_model.model(w, variant, steps, 1),
                       probe_model.model_plain(w, variant, steps, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(probe_model.CARRIES))
def test_p2_kernel_equals_plain(config, cuda):
    words = torch.zeros((1, 100), dtype=torch.int32, device=cuda)
    got = probe_model.carry(words, config, 300)
    assert torch.equal(got, probe_model.carry_plain(100, 300, config, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("level", profile_encode.LEVELS)
def test_p3_kernel_equals_plain(level, cuda):
    steps = 512
    words, sizes = p3_inputs(37, steps)
    w, s = torch.from_numpy(words).to(cuda), torch.from_numpy(sizes).to(cuda)
    out, length = profile_encode.profile(w, s, level, steps)
    p_out, p_len = profile_encode.profile_plain(w, s, level, steps)
    assert torch.equal(length, p_len)
    assert torch.equal(out, p_out)


@pytest.mark.gpu
@pytest.mark.parametrize("probe", probe_layouts.PROBES)
def test_p4_kernel_equals_plain(probe, cuda):
    steps = 300
    seed = torch.from_numpy(probe_layouts.make_seed()).to(cuda)
    if probe in probe_layouts.SCALAR:
        got = probe_layouts.scalar(seed, probe, steps)
        want = probe_layouts.scalar_plain(seed, probe, steps)
    else:
        got = probe_layouts.table(seed, probe, 70, steps)
        want = probe_layouts.table_plain(probe, 70, steps, cuda)
    assert torch.equal(got, want)
