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

P1's and P3's kernels and P4's table kernel run one chain a thread on
the codec kernels' model; numpy mirrors of their arithmetic (QuadMirror,
the coder's steps, P4's select and one-hot reads) are held to the plain
versions here.  The GPU-marked tests hold each kernel
to its plain version at 0 on the card and skip here.
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
    from gpuar_tpu_torch.bench.corpora import adversarial_underflow_packet

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


# --- The per-thread kernels' arithmetic in numpy ---------------------------
#
# csrc/probe_model.cu and csrc/profile_encode.cu run one chain a thread on
# the codec kernels' model (QuadModel).  These mirrors follow their
# arithmetic for every chain at once, with test_torch_decode's QuadMirror
# and renorm_s and packet_model.cuh's reciprocal table, and are held to
# the plain versions at 0.  ``mutant`` breaks one piece, to show that the
# comparison catches it: "row256" reads the row past the table wrongly
# (P1: C[256] instead of 0; P3: 0 instead of C[256] = 256 + t), "m" takes
# m = s for m = s - k (P3).

def wrap32(x):
    """x as int32, wrapped (two's complement)."""
    return ((np.asarray(x, np.int64) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def quad_cum(tree, s):
    """C[s] for s [B] in [0, 256] of a QuadMirror: C[256] is C[255] plus
    the count of symbol 255."""
    low = tree.prefix(np.minimum(s, 255)[:, None])[:, 0]
    return low + np.where(s == 256, tree.l3[:, 63, 3] - tree.l3[:, 63, 2], 0)


def p1_symbols(words, variant, steps):
    """The symbols each step of a P1 variant takes, [steps, tile] (v11,
    v16 and v17: [steps, 4, tile], a word's four)."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    if variant in probe_model.WORD_PER_STEP:
        return np.stack([(w[:steps] >> (8 * j)) & 0xFF for j in range(4)], 1)
    t = np.arange(steps)
    return (w[t >> 2] >> (8 * (t & 3))[:, None]) & 0xFF


# The variants whose table is updated (the others keep the initial one).
UPDATED = ("v0_3pass_256", "v1_low_only", "v2_update_only",
           "v16_unroll4_3pass", "v17_unroll4_stale", "v31_i16_3pass",
           "v32_i16_mixed")


def table_dtype(variant):
    """The numpy dtype of a P1 variant's table."""
    return np.int16 if probe_model.table_shape(variant)[1] == torch.int16 \
        else np.int32


def p1_mirror(words, variant, steps, repeat, mutant=None):
    """csrc/probe_model.cu's model_kernel for every chain of words [rows,
    tile] -> (chk int32 [tile], the final table [tile, rows])."""
    from test_torch_decode import QuadMirror

    rows, dtype = probe_model.table_shape(variant)
    i16 = dtype == torch.int16
    tile = words.shape[1]
    tree, every = QuadMirror(tile), np.ones(tile, bool)
    column = np.append(np.arange(rows), 0)   # read-only: iota, then 0
    chk = np.zeros(tile, np.int64)

    def as_row(c):   # an int16 count is its low 16 bits, sign-extended
        return ((c + 0x8000) & 0xFFFF) - 0x8000 if i16 else c

    def tree_rows(s):   # rows s and s + 1: C[s], C[s + 1], row 256 0
        high = quad_cum(tree, s + 1)
        if mutant != "row256":
            high = np.where(s == 255, 0, high)
        return as_row(quad_cum(tree, s)), as_row(high)

    def paired(m):   # paired row m, row 128 0
        v = quad_cum(tree, np.minimum(2 * m, 255)) - m \
            + ((quad_cum(tree, np.minimum(2 * m + 1, 256)) - 2 * m - 1) << 16)
        return np.where(m < 128, wrap32(v), 0)

    syms = p1_symbols(words, variant, steps)
    for _ in range(repeat):
        for t in range(steps):
            sym = syms[t]
            if variant in ("v0_3pass_256", "v31_i16_3pass", "v32_i16_mixed",
                           "v1_low_only"):
                low, high = tree_rows(sym)
                tree.bump(sym, every)
                chk += low + (high if variant != "v1_low_only" else 0)
            elif variant == "v2_update_only":
                tree.bump(sym, every)
                chk += sym
            elif variant == "v4_paired":
                pk0, pk1 = paired(sym >> 1), paired((sym >> 1) + 1)
                even = (sym & 1) == 0
                chk += np.where(even, pk0 & 0xFFFF, pk0 >> 16)
                chk += np.where(even, pk0 >> 16, pk1 & 0xFFFF)
                tree.bump(sym, every)
            elif variant == "v16_unroll4_3pass":
                for s in sym:
                    low, high = tree_rows(s)
                    tree.bump(s, every)
                    chk += low + high
            elif variant == "v17_unroll4_stale":
                for s in sym:
                    chk += sum(tree_rows(s))
                for s in sym:
                    tree.bump(s, every)
            elif variant == "v3_lowhigh_only":
                chk += column[sym] + column[sym + 1]
            elif variant == "v5_paired_1hot":
                chk += column[sym >> 1] + column[(sym >> 1) + 1]
            elif variant in ("v6_single_reduce_256", "v30_i16_reduce"):
                chk += column[sym]
            elif variant == "v7_single_reduce_128":
                chk += column[sym >> 1]
            elif variant == "v8_raw_sum_256":
                chk += column[:rows].sum() + sym
            elif variant == "v10_noload":
                chk += t & 255
            elif variant == "v11_unroll4":
                chk += sym.sum(0)
            elif variant in ("v12_20adds_row", "v13_20adds_8x128"):
                s2 = sym.copy()
                for _ in range(20):
                    s2 = s2 + (s2 >> 1)
                chk += s2
            elif variant == "v14_clz_div":
                x, d = sym * 12345 + 7, sym + 3
                inv = np.float32(1.0) / d.astype(np.float32)
                q0 = (x.astype(np.float32) * inv).astype(np.int64)
                r = x - q0 * d
                q = q0 + (r >= d) - (r < 0)
                chk += q + 32 - np.floor(np.log2(q | 1)).astype(np.int64) - 1
            elif variant == "v15_varshift":
                m = sym & 15
                chk += ((sym << m) & 0xFFFF) + (((1 << m) - 1) & 0xFFFF)
            else:
                assert variant == "v9_noop", variant
                chk += sym
            chk = wrap32(chk)
    every_row = np.broadcast_to(np.arange(rows), (tile, rows))
    if variant == "v4_paired":
        table = np.stack([paired(every_row[:, m]) for m in range(rows)], 1)
    elif variant in UPDATED:
        table = as_row(tree.prefix(every_row))
    else:
        table = every_row
    return chk.astype(np.int32), table.astype(table_dtype(variant))


def p1_counted_table(words, variant, steps, repeat):
    """The final table from a count of the symbols alone: row s is s plus
    the symbols below s (paired row m: m plus those below 2m, and those
    up to 2m in the high half); the variants that never update keep the
    initial table."""
    rows, dtype = probe_model.table_shape(variant)
    syms = p1_symbols(words, variant, steps).reshape(-1, words.shape[1])
    hist = np.stack([np.bincount(c, minlength=256) for c in syms.T]) * repeat
    below = np.cumsum(hist, 1) - hist   # symbols below s, [tile, 256]
    m = np.arange(rows)
    if variant == "v4_paired":
        table = wrap32(m + below[:, 2 * m] + ((below[:, 2 * m + 1]) << 16))
    elif variant in UPDATED:
        table = m + below
        if dtype == torch.int16:
            table = ((table + 0x8000) & 0xFFFF) - 0x8000
    else:
        table = np.broadcast_to(m, (words.shape[1], rows))
    return table.astype(table_dtype(variant))


@pytest.mark.parametrize("variant", probe_model.VARIANTS)
def test_p1_mirror_equals_plain(variant):
    """Every variant of the per-thread P1 equals the plain version at 0
    (5 chains, 256 steps, 2 repeats), and its final table equals the count
    of the symbols."""
    steps, repeat = 256, 2
    words = probe_model.make_words(probe_model.input_rows(variant, steps), 5,
                                   seed=21)
    chk, table = p1_mirror(words, variant, steps, repeat)
    want = probe_model.model_plain(torch.from_numpy(words), variant, steps,
                                   repeat)
    np.testing.assert_array_equal(chk, want.numpy())
    np.testing.assert_array_equal(
        table, p1_counted_table(words, variant, steps, repeat))


@pytest.mark.parametrize("variant", ("v31_i16_3pass", "v32_i16_mixed"))
def test_p1_mirror_i16_wrap_equals_plain(variant):
    """The int16 rows read through the wrap: row 255's count passes 32,767
    on every chain."""
    steps, words = i16_wrap_words(3)
    chk, table = p1_mirror(words, variant, steps, 1)
    want = probe_model.model_plain(torch.from_numpy(words), variant, steps, 1)
    np.testing.assert_array_equal(chk, want.numpy())
    assert (table[:, 255] < 0).all()
    np.testing.assert_array_equal(
        table, p1_counted_table(words, variant, steps, 1))


# inv(cum) = floor((2^32 - 1) / cum) for cum = 256 .. 8704.
INV = np.uint64(0xFFFFFFFF) // np.arange(256, 8705, dtype=np.uint64)


def p3_mirror(words, sizes, level, steps, mutant=None):
    """csrc/profile_encode.cu's profile_kernel for every packet of words
    [steps/4, B] and sizes [B] -> (out int32 [B, W], len int32 [B]): the
    model as QuadMirror, narrow_by with the reciprocal, renorm_s, K1's
    64-bit accumulator with one put for bits that fit in 32 and the four
    appends as puts (the run's whole fill words skipped) for longer
    ones, predicated word stores."""
    from test_torch_decode import QuadMirror, renorm_s

    n = len(sizes)
    cap = profile_encode.out_geometry(steps)[1]
    out = np.zeros((n, cap), np.int64)
    size = np.clip(sizes, 0, steps)
    w32 = words.astype(np.int64) & 0xFFFFFFFF
    model, rows = QuadMirror(n), np.arange(n)
    lo, hi = np.zeros(n, np.int64), np.full(n, 0xFFFF, np.int64)
    under, chk = np.zeros(n, np.int64), np.zeros(n, np.int64)
    acc, nb = np.zeros(n, np.uint64), np.zeros(n, np.int64)
    wcur = np.ones(n, np.int64)

    def put(v, k, on):   # BitWriter::put(v, k <= 32) where on
        nonlocal acc, nb, chk, wcur
        k = np.where(on, k, 0)
        v = np.asarray(v).astype(np.uint64)
        acc = np.where(on, (acc << k.astype(np.uint64)) | v, acc)
        nb = nb + k
        full = nb >= 32
        nb = np.where(full, nb - 32, nb)
        w = ((acc >> nb.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
             ).astype(np.int64)
        if level == 3:
            chk = chk + np.where(full, w + 1, 0)
        if level >= 4:
            r = np.nonzero(full & (wcur < cap))[0]
            out[r, wcur[r]] = w[r]
        wcur = wcur + full

    def mask(b):
        return (1 << b) - 1

    for t in range(steps):
        on = t < size
        sym = np.where(on, (w32[t >> 2] >> (8 * (t & 3))) & 0xFF, 0)
        low, high = quad_cum(model, sym), quad_cum(model, sym + 1)
        if mutant == "row256":
            high = np.where(sym == 255, 0, high)
        if level == 1:
            model.bump(sym, on)
            chk += np.where(on, low + high, 0)
            continue
        cum, inv = np.uint64(256 + t), INV[t]
        span = hi - lo + 1

        def div_by(x):
            q = (x.astype(np.uint64) * inv) >> np.uint64(32)
            return (q + (x.astype(np.uint64) - q * cum >= cum)).astype(
                np.int64)

        hi2 = (lo + div_by(high * span) - 1) & 0xFFFF
        lo2 = (lo + div_by(low * span)) & 0xFFFF
        model.bump(sym, on)
        settled = hi2
        lo2, hi2, s, k = renorm_s(lo2, hi2)
        m = s if mutant == "m" else s - k
        top = settled >> (16 - m)
        sh = np.maximum(m - 1, 0)
        if level == 2:
            chk += np.where(on, (top >> sh) + (top & mask(sh))
                            + np.where(m > 0, under, 0), 0)
        else:
            length = np.where(m > 0, m + under, 0)
            fast = length <= 32
            r = np.where(fast & (m > 0), under, 0)
            put(top + (mask(r) << sh), length, on & fast)
            slow = on & ~fast
            if slow.any():
                b0 = top >> sh
                fill = np.where(b0 > 0, 0, 0xFFFFFFFF)
                put(b0, 1, slow)
                r1 = np.minimum(under, (32 - nb) & 31)
                put(fill & mask(r1), r1, slow)
                rest = under - r1
                runw = np.where(slow, rest >> 5, 0)
                if level >= 5:
                    for p in np.nonzero(runw)[0]:
                        out[p, wcur[p]: min(wcur[p] + runw[p], cap)] = fill[p]
                wcur = wcur + runw
                put(fill & mask(rest & 31), rest & 31, slow)
                put(top & mask(sh), sh, slow)
        under = np.where(on, np.where(m > 0, k, under + k), under)
        lo, hi = np.where(on, lo2, lo), np.where(on, hi2, hi)
    if level == 1:   # each inactive step adds C[1]
        chk += (steps - size) * quad_cum(model, np.ones(n, np.int64))
    return wrap32(out).astype(np.int32), wrap32(chk + wcur).astype(np.int32)


def p3_phase8_inputs(steps=256, n=6, seed=23):
    """Phase 8's inputs at ``steps``: random packets, packet 1 the
    underflow adversary, packet 2 short and packet 3 empty."""
    from gpuar_tpu_torch.bench.corpora import adversarial_underflow_packet

    words = probe_model.make_words(steps // 4, n, seed)
    words[:, 1] = adversarial_underflow_packet(steps).view("<i4")
    sizes = np.full(n, steps, np.int32)
    sizes[2], sizes[3] = steps // 3, 0
    return words, sizes


@pytest.mark.parametrize("level", profile_encode.LEVELS)
def test_p3_mirror_equals_plain(level):
    """Each level of the per-thread P3 equals the plain version at 0 on
    phase 8's inputs: stored words and len."""
    steps = 256
    words, sizes = p3_phase8_inputs(steps)
    out, length = p3_mirror(words, sizes, level, steps)
    p_out, p_len = profile_encode.profile_plain(
        torch.from_numpy(words), torch.from_numpy(sizes), level, steps)
    np.testing.assert_array_equal(length, p_len.numpy())
    np.testing.assert_array_equal(out, p_out.numpy())
    if level == 5:   # the adversary's long runs took the four appends
        out4, _ = p3_mirror(words, sizes, 4, steps)
        assert (out4[1] != out[1]).any() and (out4[0] == out[0]).all()


@pytest.mark.parametrize("probe, mutant", [("P1", "row256"), ("P3", "row256"),
                                           ("P3", "m")])
def test_mirrors_catch_mutants(probe, mutant):
    """A mirror with a wrong row-256 read or a wrong m = s - k differs from
    the plain version on the inputs the mirror tests use (m has no
    counterpart in P1, which has no coder arithmetic)."""
    steps = 256
    if probe == "P1":
        words = probe_model.make_words(steps // 4, 5, seed=21)
        assert (words.view(np.uint8) == 255).any()
        got, _ = p1_mirror(words, "v0_3pass_256", steps, 2, mutant)
        want = probe_model.model_plain(torch.from_numpy(words),
                                       "v0_3pass_256", steps, 2)
        assert not np.array_equal(got, want.numpy())
        return
    words, sizes = p3_phase8_inputs(steps)
    plain = [profile_encode.profile_plain(torch.from_numpy(words),
                                          torch.from_numpy(sizes), level,
                                          steps)[1].numpy()
             for level in (1, 3)]
    got = [p3_mirror(words, sizes, level, steps, mutant)[1]
           for level in (1, 3)]
    # row 256 shows from L1 on; m only where the coder runs (L2 on)
    assert not np.array_equal(got[1], plain[1])
    if mutant == "row256":
        assert not np.array_equal(got[0], plain[0])


# --- P4's table probes on the codec kernels' model -------------------------
#
# csrc/probe_layouts.cu's table_kernel holds one table a thread as a
# QuadModel.  p4_mirror follows it for every table at once with
# test_torch_decode's QuadMirror: k_gather reads C[s] by QuadModel::prefix's
# selects, k_onehot by onehot_prefix's one-hot reduces, and k_update writes
# the final table by model_table.cuh's writer (row s is prefix(s)'s low).
# ``mutant`` breaks one piece: "onehot" takes the leaf's mask one digit
# off; "row256" reads C[s] as C[((s - 1) & 0xFF) + 1], right for every s
# but 0, where it reads row 256 (cum, not 0).

def p4_select_read(tree, s, mutant=None):
    """C[s] for s [B] in [0, 255] by QuadModel::prefix's selects."""
    if mutant == "row256":
        return quad_cum(tree, ((s - 1) & 0xFF) + 1)
    return tree.prefix(s[:, None])[:, 0]


def p4_onehot_read(tree, s, mutant=None):
    """C[s] for s [B] by onehot_prefix: on each level, the node's entries
    {0, S1, S2, S3} each ANDed with a mask that is all ones at the digit's
    entry, summed; level 1's S1, S2, S3 of node 1 + j0 each a reduce over
    the 4 level-1 nodes."""
    rows = np.arange(len(s))
    j0, j1, j2, j3 = s >> 6, (s >> 4) & 3, (s >> 2) & 3, s & 3
    if mutant == "onehot":
        j3 = (j3 + 1) & 3

    def reduce(j, entries):
        return sum(e & -(j == k).astype(np.int64)
                   for k, e in enumerate(entries))

    zero = np.zeros(len(s), np.int64)
    level1 = [reduce(j0, tree.l1[:, :, i].T) for i in range(3)]
    return (reduce(j0, [zero, *tree.r.T]) + reduce(j1, [zero, *level1])
            + reduce(j2, [zero, *tree.l2[rows, s >> 4, :3].T])
            + reduce(j3, [zero, *tree.l3[rows, s >> 2, :3].T]))


def p4_mirror(probe, n, steps, mutant=None):
    """csrc/probe_layouts.cu's table_kernel for tables 0..n-1 -> k_update:
    the final tables int32 [n, 256]; k_gather, k_onehot: each table's
    16-bit running sum int32 [n]."""
    from test_torch_decode import QuadMirror

    tree, every, b = QuadMirror(n), np.ones(n, bool), np.arange(n)
    read = p4_onehot_read if probe == "k_onehot" else p4_select_read
    acc = np.zeros(n, np.int64)
    for t in range(steps):
        s = (7 * b + t) & 0xFF
        if probe != "k_update":
            acc = (acc + read(tree, s, mutant)) & 0xFFFF
        tree.bump(s, every)
    if probe == "k_update":
        return np.stack([p4_select_read(tree, np.full(n, s), mutant)
                         for s in range(256)], 1).astype(np.int32)
    return acc.astype(np.int32)


@pytest.mark.parametrize("probe", probe_layouts.TABLE)
def test_p4_mirror_equals_plain(probe):
    """Each table probe on the per-thread tree equals the plain version at
    0: 100 tables (no multiple of 64), 600 steps, so every symbol is
    counted at least twice in every table."""
    n, steps = 100, 600
    want = probe_layouts.table_plain(probe, n, steps)
    np.testing.assert_array_equal(p4_mirror(probe, n, steps), want.numpy())


def test_p4_onehot_read_equals_select_read():
    """The one-hot read equals prefix's select read for every symbol, on
    trees that have counted random symbols."""
    from test_torch_decode import QuadMirror

    rng = np.random.default_rng(31)
    n = 8
    tree = QuadMirror(n)
    for _ in range(500):
        tree.bump(rng.integers(0, 256, n), np.ones(n, bool))
    for s in range(256):
        sym = np.full(n, s)
        np.testing.assert_array_equal(p4_onehot_read(tree, sym),
                                      p4_select_read(tree, sym))


@pytest.mark.parametrize("probe, mutant", [("k_gather", "row256"),
                                           ("k_update", "row256"),
                                           ("k_onehot", "onehot")])
def test_p4_mirrors_catch_mutants(probe, mutant):
    """A P4 mirror with a one-hot mask one digit off, or with row 256 read
    in place of C[0] = 0, differs from the plain version on the inputs
    that test_p4_mirror_equals_plain uses."""
    n, steps = 100, 600
    want = probe_layouts.table_plain(probe, n, steps).numpy()
    assert not np.array_equal(p4_mirror(probe, n, steps, mutant), want)


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
@pytest.mark.parametrize("variant", ("v0_3pass_256", "v4_paired",
                                     "v8_raw_sum_256", "v11_unroll4",
                                     "v17_unroll4_stale", "v30_i16_reduce"))
def test_p1_kernel_past_whole_chunks_equals_plain(variant, cuda):
    """The kernel reads its words in chunks of 4: at 172 steps (43 words)
    and, one word a step, 174, the last 3 or 2 words are read one at a
    time."""
    steps = 174 if variant in probe_model.WORD_PER_STEP else 172
    repeat, tile = 3, 70
    words = torch.from_numpy(probe_model.make_words(
        probe_model.input_rows(variant, steps), tile, seed=9)).to(cuda)
    assert torch.equal(probe_model.model(words, variant, steps, repeat),
                       probe_model.model_plain(words, variant, steps, repeat))


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


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(probe_model.CARRIES))
def test_p2_kernel_at_k1_width_equals_plain(config, cuda):
    """One chain a thread in blocks of 64, at K1's batch of 8192 chains
    (test_p2_kernel_equals_plain takes 100, a partial block)."""
    words = torch.zeros((1, 8192), dtype=torch.int32, device=cuda)
    got = probe_model.carry(words, config, 1001)
    assert torch.equal(got, probe_model.carry_plain(8192, 1001, config, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("n", (100, 8192))
@pytest.mark.parametrize("probe", probe_layouts.TABLE)
def test_p4_table_kernel_equals_plain(probe, n, cuda):
    """One table a thread on PacketModel: 100 tables end in a partial
    block, 8192 are K1's batch; 600 steps count every symbol at least
    twice."""
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = probe_layouts.table(seed, probe, n, 600)
    assert torch.equal(got, probe_layouts.table_plain(probe, n, 600, cuda))


@pytest.mark.gpu
def test_p2_p4_launch_one_chain_a_thread(cuda):
    """P2 and P4's table probes launch 64 threads a block; P4's tables
    take PacketModel's shared memory, as the codec kernels do."""
    from gpuar_tpu_torch.ops import _kernels

    assert _kernels.launch_shape("gpuar_probe_carry_shape") == (64, 0)
    assert _kernels.launch_shape("gpuar_probe_table_shape") \
        == _kernels.launch_shape("gpuar_decode_shape") == (64, 81920)
