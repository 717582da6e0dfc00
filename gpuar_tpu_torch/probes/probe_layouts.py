"""P4: the costs of the inner-loop primitives.

The counterpart of ``benchmarks/probe_layouts.py`` (``k_base`` ..
``k_onehot``, their ``pallas_call`` in ``call``), on the H100 in
``csrc/probe_layouts.cu``.

  * The scalar probes run ``steps`` steps of one chain per element of the
    [8, 128] seed: the loop alone, 60 adds, 4 variable shifts natively or
    by the float32 exponent trick, 4 leading-zero counts natively or from
    a float32 exponent.
  * The table probes keep one 256-entry model per table b of B and count
    symbol (7b + t) & 0xFF at step t: the update alone (``k_update``, the
    final tables), a gather of the symbol's entry before the update
    (``k_gather``) and the one-hot form of that read (``k_onehot``), both
    giving each table's 16-bit running sum.  On the H100 a table is one
    thread's 4-ary prefix tree, the codec kernels' model, and the reads
    are that model's own read, by selects or one-hot reduces.

``scalar`` / ``table`` take a CUDA tensor to the kernel and a CPU tensor
to the plain versions, which repeat the probe's arithmetic step by step;
the float32 tricks are IEEE multiplies and truncating conversions in both.
``tpu_output`` cuts a result to the TPU probe's [8, 128] output.
"""

from __future__ import annotations

import numpy as np
import torch

from gpuar_tpu_torch import probes
from gpuar_tpu_torch.ops.torch_codec import _clz16

STEPS = 8192
B = 1024
TABLES = (B, 8192)   # the table probes' widths timed: the probe's, K1's batch
U16 = 0xFFFF
# In the order of csrc/probe_layouts.cu's Scalar and Table enums.
SCALAR = ("k_base", "k_adds", "k_varshift", "k_f32shift", "k_clz", "k_clzf")
TABLE = ("k_update", "k_gather", "k_onehot")
PROBES = SCALAR + TABLE
DEFAULT = "k_onehot"   # K1's model read in one-hot form, and its update
NAMES = {"k_base": "base loop", "k_adds": "60 adds [8,128]",
         "k_varshift": "4 native varshifts [8,128]",
         "k_f32shift": "4 f32-trick varshifts [8,128]",
         "k_clz": "4 native clz [8,128]", "k_clzf": "4 f32 clz [8,128]",
         "k_update": "model update [B,256]",
         "k_gather": "update+gather [B,256]",
         "k_onehot": "one-hot reduce [256,B]"}


def make_seed() -> np.ndarray:
    """The probes' seed: int32 [8, 128] in [1, 255) (probe_layouts.call)."""
    return np.random.default_rng(0).integers(1, 255, (8, 128), np.int32)


def _check(seed: torch.Tensor) -> None:
    if seed.dtype != torch.int32:
        raise ValueError(f"seed must be int32, got {seed.dtype}")


def scalar(seed: torch.Tensor, probe: str, steps: int = STEPS):
    """A scalar probe: each element of seed runs ``steps`` steps -> int32
    of seed's shape."""
    _check(seed)
    if probe not in SCALAR:
        raise ValueError(f"unknown scalar probe {probe!r}")
    if not probes.on_cuda(seed):
        return scalar_plain(seed, probe, steps)
    seed = seed.contiguous()
    out = torch.empty_like(seed)
    probes.launch("probe_layouts", "gpuar_probe_scalar", seed.device,
                  seed.data_ptr(), seed.numel(), steps, SCALAR.index(probe),
                  out.data_ptr())
    return out


def table(seed: torch.Tensor, probe: str, n: int = B, steps: int = STEPS):
    """A table probe over n tables (seed only names the device, as the
    TPU probe's seed is read by no table probe) -> k_update: the final
    tables int32 [n, 256]; k_gather, k_onehot: each table's running sum
    int32 [n]."""
    _check(seed)
    if probe not in TABLE:
        raise ValueError(f"unknown table probe {probe!r}")
    if not probes.on_cuda(seed):
        return table_plain(probe, n, steps, seed.device)
    dev = seed.device
    tables = torch.empty((n, 256) if probe == "k_update" else (1, 1),
                         dtype=torch.int32, device=dev)
    acc = torch.empty(n if probe != "k_update" else 1, dtype=torch.int32,
                      device=dev)
    probes.launch("probe_layouts", "gpuar_probe_table", dev, n, steps,
                  TABLE.index(probe), tables.data_ptr(), acc.data_ptr())
    return tables if probe == "k_update" else acc


def _pow2f(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32, from its bits (pltpu.bitcast((e + 127) << 23))."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def _f32_scale(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) * p).to(torch.int32)


def _shl16(x, m):
    p = _pow2f(m)
    return (_f32_scale(x & 0xFF, p) + (_f32_scale(x >> 8, p) << 8)) & U16


def _shr(x, m):
    return _f32_scale(x, _pow2f(-m))


def _clz16f(x):
    e = (x.to(torch.float32).view(torch.int32) >> 23) & 0xFF
    return torch.where(x > 0, 142 - e, 16)


def scalar_plain(seed: torch.Tensor, probe: str, steps: int = STEPS):
    x = seed.clone()
    for t in range(steps):
        if probe == "k_base":
            x = (x + t) & U16
        elif probe == "k_adds":
            for _ in range(20):
                x = ((x + 1) & U16 | 1) ^ 3
        elif probe in ("k_varshift", "k_f32shift"):
            m = x & 15
            for _ in range(4):
                if probe == "k_varshift":
                    x = ((x << m) | (x >> (16 - m))) & U16
                else:
                    x = (_shl16(x, m) | _shr(x & U16, 16 - m)) & U16
            x = x | 1
        else:
            for _ in range(4):
                # k_clz: lax.clz of the 32-bit word (x is below 2**16).
                z = _clz16(x | 1) + 16 if probe == "k_clz" \
                    else _clz16f(x | 1)
                x = (x + z) & U16
            x = x | 1
    return x


def table_plain(probe: str, n: int = B, steps: int = STEPS,
                device: torch.device | str = "cpu"):
    i32 = torch.int32
    iota = torch.arange(256, dtype=i32, device=device)[None, :]
    rows = torch.arange(n, dtype=i32, device=device)[:, None]
    C = iota.expand(n, 256).clone()
    acc = torch.zeros(n, dtype=i32, device=device)
    for t in range(steps):
        c = (rows * 7 + t) & 0xFF
        if probe == "k_gather":
            acc = (acc + C.gather(1, c.long())[:, 0]) & U16
        elif probe == "k_onehot":
            acc = (acc + torch.where(iota == c, C, 0).sum(1).to(i32)) & U16
        C += (iota > c).to(i32)
    return C if probe == "k_update" else acc


def tpu_output(probe: str, result: torch.Tensor) -> torch.Tensor:
    """The TPU probe's [8, 128] output from a port result: the seed's
    shape for a scalar probe; the first 8 tables' first 128 entries
    (k_update); the first 8 tables' sums along rows (k_gather); the first
    128 tables' sums along columns (k_onehot)."""
    if probe in SCALAR:
        return result.reshape(8, 128)
    if probe == "k_update":
        return result[:8, :128]
    if probe == "k_gather":
        return result[:8, None].expand(8, 128)
    return result[None, :128].expand(8, 128)
