"""P3: the encoder's phase ablation.

The counterpart of ``benchmarks/profile_encode.py`` (``make_kernel``, its
``pallas_call`` in ``call``).  Level L runs phases 1..L of an encoder step
on each packet (a lane of the TPU's tile; a warp of
``csrc/profile_encode.cu`` on the H100):

  1. the model: two table reads and the suffix update;
  2. + the range narrowing and renormalisation;
  3. + the bit appends into a 32-bit accumulator;
  4. + the stores of each completed word;
  5. + the stores of an underflow run's whole fill words.

Each level gives the probe's ``len = chk + wcur`` per packet
(profile_encode.py:165): levels 1 to 3 fold what they compute into
``chk``, and ``wcur`` counts the stream's words from 1 (the header's).
The TPU's 16-word VMEM ring and its dump into the output tile have no
counterpart here: from level 4 each word is stored at its index ``wcur``
of the packet's row of ``out``, as K1 stores its words.

``profile`` takes a CUDA tensor to the kernel and a CPU tensor to
``profile_plain``, which repeats the probe's step in int32 tensors over
the packets.
"""

from __future__ import annotations

import torch

from gpuar_tpu_torch import probes
from gpuar_tpu_torch.ops.encode import out_geometry
from gpuar_tpu_torch.ops.torch_codec import _renorm

B = 4096
STEPS = 8192
LEVELS = (1, 2, 3, 4, 5)
DEFAULT_LEVEL = 5   # the whole encoder step
U16 = 0xFFFF


def _check(words: torch.Tensor, sizes: torch.Tensor, level: int,
           steps: int) -> None:
    n = sizes.shape[0] if sizes.dim() == 1 else -1
    if sizes.dtype != torch.int32 or n < 0:
        raise ValueError(f"sizes must be int32 [B], got {sizes.dtype} "
                         f"{tuple(sizes.shape)}")
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != n or words.shape[0] < steps // 4:
        raise ValueError(f"words must be int32 [>= {steps // 4}, {n}], got "
                         f"{words.dtype} {tuple(words.shape)}")
    if words.device != sizes.device:
        raise ValueError("words and sizes must be on one device")
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level}")


def profile(words: torch.Tensor, sizes: torch.Tensor, level: int,
            steps: int = STEPS):
    """words int32 [steps/4, B] (packet b's bytes are column b, little
    endian), sizes int32 [B] -> (out int32 [B, W], the stored words, zero
    below level 4; len int32 [B]).  W is K1's row of a ``steps``-byte
    packet."""
    _check(words, sizes, level, steps)
    if not probes.on_cuda(words):
        return profile_plain(words, sizes, level, steps)
    out_words = out_geometry(steps)[1]
    n = sizes.shape[0]
    words = words[: steps // 4].contiguous()
    sizes = sizes.contiguous()
    out = torch.zeros((n, out_words), dtype=torch.int32, device=words.device)
    length = torch.empty(n, dtype=torch.int32, device=words.device)
    probes.launch("profile_encode", "gpuar_profile_encode", words.device,
                  sizes.data_ptr(), words.data_ptr(), n, steps, level,
                  out.data_ptr(), out_words, length.data_ptr())
    return out, length


def profile_plain(words: torch.Tensor, sizes: torch.Tensor, level: int,
                  steps: int = STEPS):
    """Plain P3 on words' device: ``make_kernel``'s step on [B] tensors,
    with the plain codec's renormalisation (``torch_codec._renorm``)."""
    out_words = out_geometry(steps)[1]
    i32 = torch.int32
    dev, n = words.device, sizes.shape[0]
    iota = torch.arange(256, dtype=i32, device=dev)[:, None]
    C = iota.expand(256, n).clone()
    # One column past the row takes the stores that fall outside it.
    out = torch.zeros((n, out_words + 1), dtype=i32, device=dev)
    lanes = torch.arange(n, device=dev)
    one = torch.ones(n, dtype=i32, device=dev)
    zeros = torch.zeros(n, dtype=i32, device=dev)
    lower, upper, under, acc, nbuf, chk = (zeros, zeros + U16, zeros, zeros,
                                           zeros, zeros)
    wcur = zeros + 1

    def read(s):
        return torch.where(iota == s, C, 0).sum(0).to(i32)

    def append(acc, nbuf, val, k):
        newn = nbuf + k
        over = (newn - 32).clamp(min=0)
        flushing = newn >= 32
        word = torch.where(flushing, acc | (val >> over), 0)
        rem = val & ((one << over) - 1)
        acc2 = torch.where(flushing, rem << ((32 - over) & 31),
                           acc | (val << (32 - newn).clamp(0, 31)))
        return (acc2, torch.where(flushing, over, newn), word,
                flushing.to(i32))

    def store(word, at, flushing):
        at = torch.where((flushing > 0) & (at < out_words), at, out_words)
        out[lanes, at] = word

    for tt in range(steps):
        active = tt < sizes
        sym = torch.where(active, (words[tt >> 2] >> ((tt & 3) * 8)) & 0xFF,
                          0)
        cum = 256 + tt

        # L1: the model.
        low = read(sym)
        high = read(sym + 1) + (sym == 255).to(i32) * cum
        C += (active & (iota > sym)).to(i32)
        if level == 1:
            chk = chk + low + high
            continue

        # L2: range narrowing and renormalisation.
        span = upper - lower + 1
        up2 = (lower + (high * span) // cum - 1) & U16
        lo2 = (lower + (low * span) // cum) & U16
        lo3, up3, m, k = _renorm(lo2, up2)
        topm = (up2 >> (16 - m)) & ((one << m) - 1)
        has = (m > 0) & active
        b0 = torch.where(has, topm >> (m - 1).clamp(min=0), 0)
        u_drain = torch.where(has, under, 0)
        npat = (torch.where(has, m, 0) - 1).clamp(min=0)
        pat = torch.where(has, topm & ((one << npat) - 1), 0)
        under2 = torch.where(has, 0, under) + torch.where(active, k, 0)
        lower = torch.where(active, lo3, lower)
        upper = torch.where(active, up3, upper)
        if level == 2:
            chk = chk + b0 + pat + u_drain
            under = under2
            continue

        # L3: the bit appends.
        acc, nbuf, w1, f1 = append(acc, nbuf, b0, has.to(i32))
        r1 = torch.minimum(u_drain, (32 - nbuf) & 31)
        fill = b0 == 0   # the run's bits are ~b0
        acc, nbuf, w2, f2 = append(acc, nbuf,
                                   torch.where(fill, (one << r1) - 1, 0), r1)
        left = u_drain - r1
        runw = left >> 5
        left = left - (runw << 5)
        acc, nbuf, w3, f3 = append(acc, nbuf,
                                   torch.where(fill, (one << left) - 1, 0),
                                   left)
        acc, nbuf, w4, f4 = append(acc, nbuf, pat, npat)
        under = under2
        if level == 3:
            chk = chk + w1 + w2 + w3 + w4 + f1 + f2 + f3 + f4
            wcur = wcur + f1 + f2 + f3 + f4 + runw
            continue

        # L4: the word stores; L5: the run's whole fill words too.
        store(w1, wcur, f1)
        wcur = wcur + f1
        store(w2, wcur, f2)
        wcur = wcur + f2
        if level >= 5 and bool((runw > 0).any()):
            for p in torch.nonzero(runw > 0)[:, 0].tolist():
                a0 = int(wcur[p])
                out[p, a0: min(a0 + int(runw[p]), out_words)] = \
                    -1 if bool(fill[p]) else 0
        wcur = wcur + runw
        store(w3, wcur, f3)
        wcur = wcur + f3
        store(w4, wcur, f4)
        wcur = wcur + f4
    return out[:, :out_words].contiguous(), chk + wcur
