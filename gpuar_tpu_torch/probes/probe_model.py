"""P1 and P2: the model-update and loop-carry probes.

The counterparts of ``benchmarks/probe_model.py``: P1 is the kernel family
of ``make`` (its ``pallas_call`` in ``run``), P2 the kernel of
``run_carry``.  Each chain (a lane of the TPU's tile) reads symbols from
its column of the input words and updates a 256-row table of counts (128
rows of packed 16-bit pairs in the paired forms, int16 counts in the i16
forms); the output is a checksum ``chk`` per chain, a deterministic
function of the input.  On the H100 (``csrc/probe_model.cu``) a P1 chain
is one thread, in blocks of 64, on the codec kernels' model: the updated
tables are the 4-ary prefix tree of ``csrc/packet_model.cuh``, the
read-only ones a column of shared memory; a P2 chain is one thread too,
its carries in registers.

``model`` / ``carry`` take a CUDA tensor to the kernel and a CPU tensor to
``model_plain`` / ``carry_plain``, which repeat the probe's arithmetic
step by step in int32 (and int16) tensors that wrap as the TPU's do.

The TPU's ``v11_unroll4``, ``v16_unroll4_3pass`` and ``v17_unroll4_stale``
read input row t for every step t < STEPS from an input of STEPS/4 rows,
so their TPU output is undefined; here they take a [STEPS, TILE] input
(``input_rows``).
"""

from __future__ import annotations

import numpy as np
import torch

from gpuar_tpu_torch import probes
from gpuar_tpu_torch.ops.torch_codec import _clz16

TILE = 512
TILES = (TILE, 8192)   # the widths timed: the probe's and one K1 batch
STEPS = 8192
REPEAT = 8
U16 = 0xFFFF

# In the order of csrc/probe_model.cu's Variant enum.
VARIANTS = (
    "v0_3pass_256", "v1_low_only", "v2_update_only", "v3_lowhigh_only",
    "v4_paired", "v5_paired_1hot", "v6_single_reduce_256",
    "v7_single_reduce_128", "v8_raw_sum_256", "v10_noload", "v11_unroll4",
    "v12_20adds_row", "v13_20adds_8x128", "v14_clz_div", "v15_varshift",
    "v16_unroll4_3pass", "v17_unroll4_stale", "v30_i16_reduce",
    "v31_i16_3pass", "v32_i16_mixed", "v9_noop",
)
WORD_PER_STEP = frozenset(("v11_unroll4", "v16_unroll4_3pass",
                           "v17_unroll4_stale"))
# P2, probe_model.py:255-260: name -> (carries, packed, unroll).
CARRIES = {
    "1x(1,512)": (1, False, 1),
    "4x(1,512)": (4, False, 1),
    "8x(1,512)": (8, False, 1),
    "1x(8,512)": (8, True, 1),
    "8sep_unroll4": (8, False, 4),
    "8pack_unroll4": (8, True, 4),
}
DEFAULT_VARIANT = "v0_3pass_256"   # the whole model step: 2 reads, update
DEFAULT_CARRY = "1x(1,512)"


def table_shape(variant: str) -> tuple[int, torch.dtype]:
    """(rows, dtype) of the variant's table, as ``make`` chooses them."""
    rows = 128 if ("paired" in variant or "128" in variant) else 256
    return rows, torch.int16 if "i16" in variant else torch.int32


def input_rows(variant: str, steps: int = STEPS) -> int:
    return steps if variant in WORD_PER_STEP else steps // 4


def make_words(rows: int, tile: int, seed: int = 0) -> np.ndarray:
    """The probes' input: int32 words [rows, tile] below 2**31."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 31, (rows, tile), np.int64).astype(np.int32)


def _check(words: torch.Tensor, rows: int) -> None:
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"words must be int32 [rows, tile], got "
                         f"{words.dtype} {tuple(words.shape)}")
    if words.shape[0] < rows:
        raise ValueError(f"words has {words.shape[0]} rows, needs {rows}")


def model(words: torch.Tensor, variant: str, steps: int = STEPS,
          repeat: int = REPEAT) -> torch.Tensor:
    """P1: words int32 [rows >= input_rows(variant, steps), tile] -> chk
    int32 [tile] after ``repeat`` passes of ``steps`` steps."""
    _check(words, input_rows(variant, steps))
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if not probes.on_cuda(words):
        return model_plain(words, variant, steps, repeat)
    words = words.contiguous()
    tile = words.shape[1]
    out = torch.empty(tile, dtype=torch.int32, device=words.device)
    rows, dtype = table_shape(variant)
    # The kernel leaves its final tables here, as the TPU probe's stay in
    # its scratch; only chk is the probe's output.
    table = torch.empty((tile, rows), dtype=dtype, device=words.device)
    probes.launch("probe_model", "gpuar_probe_model", words.device,
                  words.data_ptr(), words.shape[0], tile, steps, repeat,
                  VARIANTS.index(variant), out.data_ptr(), table.data_ptr())
    return out


def model_plain(words: torch.Tensor, variant: str, steps: int = STEPS,
                repeat: int = REPEAT) -> torch.Tensor:
    """Plain P1 on words' device: one step of [rows, tile] tensor ops per
    symbol, as ``probe_model.make``'s step."""
    i32 = torch.int32
    dev, tile = words.device, words.shape[1]
    rows, dtype = table_shape(variant)
    iota = torch.arange(rows, dtype=i32, device=dev)[:, None]
    C = iota.to(dtype).expand(rows, tile).clone()
    zero = torch.zeros((), dtype=dtype, device=dev)
    chk = torch.zeros(tile, dtype=i32, device=dev)

    def read(s):   # row s of the table per chain, 0 past it (one-hot sum)
        return torch.where(iota == s, C, zero).sum(0).to(i32)

    def gt(s):     # 1 in every row above s
        return (iota > s).to(dtype)

    for _ in range(repeat):
        for t in range(steps):
            if variant in WORD_PER_STEP:
                w = words[t]
                syms = [(w >> (8 * j)) & 0xFF for j in range(4)]
            elif variant != "v10_noload":
                sym = (words[t >> 2] >> ((t & 3) * 8)) & 0xFF
            if variant in ("v0_3pass_256", "v31_i16_3pass", "v32_i16_mixed"):
                low, high = read(sym), read(sym + 1)
                C += gt(sym)
                chk = chk + low + high
            elif variant == "v1_low_only":
                low = read(sym)
                C += gt(sym)
                chk = chk + low
            elif variant == "v2_update_only":
                C += gt(sym)
                chk = chk + sym
            elif variant == "v3_lowhigh_only":
                chk = chk + read(sym) + read(sym + 1)
            elif variant == "v4_paired":
                mrow, even = sym >> 1, (sym & 1) == 0
                pk0, pk1 = read(mrow), read(mrow + 1)
                low = torch.where(even, pk0 & U16, pk0 >> 16)
                high = torch.where(even, pk0 >> 16, pk1 & U16)
                eq = (even & (iota == mrow)).to(i32)
                C += gt(mrow) * 0x10001 + (eq << 16)
                chk = chk + low + high
            elif variant == "v5_paired_1hot":
                chk = chk + read(sym >> 1) + read((sym >> 1) + 1)
            elif variant in ("v6_single_reduce_256", "v30_i16_reduce"):
                chk = chk + read(sym)
            elif variant == "v7_single_reduce_128":
                chk = chk + read(sym >> 1)
            elif variant == "v8_raw_sum_256":
                chk = chk + C.sum(0).to(i32) + sym
            elif variant == "v10_noload":
                chk = chk + (t & 255)
            elif variant == "v11_unroll4":
                for s in syms:
                    chk = chk + s
            elif variant in ("v12_20adds_row", "v13_20adds_8x128"):
                s2 = sym
                for _ in range(20):
                    s2 = s2 + (s2 >> 1)
                chk = chk + s2
            elif variant == "v14_clz_div":
                q = _exact_div(sym * 12345 + 7, sym + 3)
                # clz of the 32-bit word; q is below 2**24.
                chk = chk + q + _clz16(q | 1) + 16
            elif variant == "v15_varshift":
                m = sym & 15
                chk = chk + ((sym << m) & U16) \
                    + (((torch.ones_like(m) << m) - 1) & U16)
            elif variant == "v16_unroll4_3pass":
                for s in syms:
                    low, high = read(s), read(s + 1)
                    C += gt(s)
                    chk = chk + low + high
            elif variant == "v17_unroll4_stale":
                upd = gt(syms[0])
                for j, s in enumerate(syms):
                    chk = chk + read(s) + read(s + 1)
                    if j:
                        upd = upd + gt(s)
                C += upd
            elif variant == "v9_noop":
                chk = chk + sym
    return chk


def _exact_div(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """probe_model._exact_div_probe: a float32 quotient estimate (IEEE
    reciprocal and multiply, truncated), corrected by one either way."""
    q0 = (x.to(torch.float32) * (1.0 / d.to(torch.float32))).to(torch.int32)
    r = x - q0 * d
    return q0 + (r >= d).to(torch.int32) - (r < 0).to(torch.int32)


def carry(words: torch.Tensor, config: str,
          iters: int = STEPS * REPEAT) -> torch.Tensor:
    """P2: ``iters`` iterations of the carries of ``config`` (CARRIES) over
    words.shape[1] chains -> int32 [tile].  Like the TPU probe, it takes
    the words and reads none of them."""
    _check(words, 0)
    ncarry, packed, unroll = CARRIES[config]
    if not probes.on_cuda(words):
        return carry_plain(words.shape[1], iters, config, words.device)
    # A packed carry's every row is stored; row 0 is the probe's output.
    out = torch.empty((ncarry if packed else 1, words.shape[1]),
                      dtype=torch.int32, device=words.device)
    probes.launch("probe_carry", "gpuar_probe_carry", words.device,
                  words.shape[1], iters, ncarry, int(packed), unroll,
                  out.data_ptr())
    return out[0]


def carry_plain(tile: int, iters: int, config: str,
                device: torch.device) -> torch.Tensor:
    """Plain P2: the carries as rows of one [n, tile] int32 tensor, each
    row c -> c + (c >> 1) + t, ``unroll`` times per iteration t; the
    result is row 0 of a packed carry, else the (wrapping) sum of the
    carries."""
    ncarry, packed, unroll = CARRIES[config]
    c = torch.zeros((ncarry, tile), dtype=torch.int32, device=device)
    for t in range(iters):
        for _ in range(unroll):
            c = c + (c >> 1) + t
    return c[0] if packed else c.sum(0).to(torch.int32)
