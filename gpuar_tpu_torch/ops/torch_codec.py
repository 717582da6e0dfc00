"""Plain PyTorch versions of the codec kernels (K1 encode, K2/K3 decode).

A port of ``gpuar_tpu/ops/xla_codec.py``: packets are batched along the
first tensor axis and a Python loop walks the symbol steps, with the same
closed-form renormalisation (see that module's docstring for the
derivation).  These are the correctness anchors of the CUDA kernels in
``gpuar_tpu_torch/csrc``: ``ops.encode`` / ``ops.decode`` run them for
tensors that lie on the CPU, and ``chip_smoke.py`` holds each kernel
against them on the card.  They run on any device but are slow (one
batch of small tensor ops per symbol step); the encoder's output stage
is the host packer ``ops.bitpack.pack_batch``.

All state is int64, so no intermediate can overflow.
"""

from __future__ import annotations

import torch

from gpuar_tpu_torch.config import MODEL_SIZE, PACKET_HEADER_LENGTH

U16 = 0xFFFF


def _clz16(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of a 16-bit value (clz16(0) = 16); frexp's exponent is
    the bit length, exact for integers below 2**24."""
    return 16 - torch.frexp(x.to(torch.float32)).exponent.to(x.dtype)


def _initial_model(batch: int, device) -> tuple[torch.Tensor, ...]:
    """Model and coder state at a packet start: every count 1, cum 256,
    bounds [0, 0xFFFF]."""
    C = torch.arange(MODEL_SIZE, dtype=torch.int64, device=device)
    C = C.expand(batch, MODEL_SIZE).clone()
    cum = torch.full((batch,), 256, dtype=torch.int64, device=device)
    lower = torch.zeros(batch, dtype=torch.int64, device=device)
    upper = torch.full((batch,), U16, dtype=torch.int64, device=device)
    return C, cum, lower, upper


def _apply_symbol_range(C, cumprob, sym, lower, upper):
    """Narrow the bounds to sym's share, then adapt the model."""
    low = C.gather(1, sym[:, None])[:, 0]
    high = C.gather(1, sym[:, None] + 1)[:, 0]
    span = upper - lower + 1
    new_upper = (lower + (high * span) // cumprob - 1) & U16
    new_lower = (lower + (low * span) // cumprob) & U16
    iota = torch.arange(MODEL_SIZE, dtype=torch.int64, device=C.device)
    C_new = C + (iota[None, :] > sym[:, None]).to(torch.int64)
    return C_new, cumprob + 1, new_lower, new_upper


def _renorm(lower, upper):
    """Closed-form renormalisation -> (new_lower, new_upper, m, k)."""
    m = _clz16(lower ^ upper)
    LA = (lower << m) & U16
    UA = ((upper << m) | ((1 << m) - 1)) & U16
    A = (LA << 1) & U16
    B = ((UA << 1) | 1) & U16
    k = _clz16((~(A & ~B)) & U16)
    new_lower = (LA << k) & 0x7FFF
    new_upper = (((UA << k) | ((1 << k) - 1)) | 0x8000) & U16
    return new_lower, new_upper, m, k


def encode_scan(symbols: torch.Tensor, sizes: torch.Tensor):
    """symbols [steps, B], sizes [B] -> (desc [steps, B], pat [steps, B],
    tail_bit [B], tail_run [B]), int64, in ``ops.bitpack``'s descriptor
    layout."""
    steps, batch = symbols.shape
    dev = symbols.device
    symbols = symbols.to(torch.int64)
    sizes = sizes.to(device=dev, dtype=torch.int64)
    C, cum, lower, upper = _initial_model(batch, dev)
    under = torch.zeros(batch, dtype=torch.int64, device=dev)
    desc = torch.zeros((steps, batch), dtype=torch.int64, device=dev)
    pat = torch.zeros((steps, batch), dtype=torch.int64, device=dev)
    for t in range(min(steps, int(sizes.max()) if batch else 0)):
        active = t < sizes
        C2, cum2, lo2, up2 = _apply_symbol_range(C, cum, symbols[t], lower,
                                                 upper)
        lo3, up3, m, k = _renorm(lo2, up2)
        # Emission: first settled bit b0, the drained underflow run, then
        # the remaining m-1 settled bits (all from the pre-shift upper).
        topm = (up2 >> (16 - m)) & ((1 << m) - 1)
        has = m > 0
        m1 = (m - 1).clamp(min=0)
        b0 = (topm >> m1) & has.to(torch.int64)
        desc[t] = torch.where(
            active, (torch.where(has, under, 0) << 6) | (m << 1) | b0, 0)
        pat[t] = torch.where(active, topm & ((1 << m1) - 1), 0)
        under = torch.where(active, torch.where(has, 0, under) + k, under)
        C = torch.where(active[:, None], C2, C)
        cum = torch.where(active, cum2, cum)
        lower = torch.where(active, lo3, lower)
        upper = torch.where(active, up3, upper)
    return desc, pat, (lower >> 14) & 1, under + 1


def decode_scan(words: torch.Tensor, raw_sizes: torch.Tensor, steps: int,
                debug: bool = False):
    """words [B, W] (the bitstream as MSB-first u32 values, header
    stripped), raw_sizes [B] -> symbols [steps, B] uint8; with
    ``debug=True`` also flags [2, B] int32 (K3's layout): row 0 is nonzero
    where a step saw ``unscaled`` outside [0, cum) or ``lower > upper``,
    row 1 is the final bit cursor counted from the packet start, header
    included.  Bits past the end of ``words`` read as zero."""
    batch, nwords = words.shape
    dev = words.device
    words = words.to(torch.int64)
    raw_sizes = raw_sizes.to(device=dev, dtype=torch.int64)
    C, cum, lower, upper = _initial_model(batch, dev)
    rows = torch.arange(batch, device=dev)
    code = words[:, 0] >> 16 if nwords else torch.zeros_like(lower)
    bitpos = torch.full((batch,), 16, dtype=torch.int64, device=dev)
    flag = torch.zeros(batch, dtype=torch.bool, device=dev)
    syms = torch.zeros((steps, batch), dtype=torch.uint8, device=dev)

    def word(i):
        ok = i < nwords
        return torch.where(ok, words[rows, i.clamp(max=max(nwords - 1, 0))],
                           0)

    for t in range(min(steps, int(raw_sizes.max()) if batch else 0)):
        active = t < raw_sizes
        span = (upper - lower + 1).clamp(min=1)
        num = (code - lower + 1) * cum - 1
        unscaled = num // span
        sym = (C[:, 1:] <= unscaled[:, None]).sum(1).clamp(0, 255)
        C2, cum2, lo2, up2 = _apply_symbol_range(C, cum, sym, lower, upper)
        if debug:
            bad = (unscaled >= cum) | (unscaled < 0) | (lo2 > up2)
            flag = flag | (active & bad)
        lo3, up3, m, k = _renorm(lo2, up2)
        s = m + k
        widx = bitpos >> 5
        boff = bitpos & 31
        win = ((word(widx) << boff) | (word(widx + 1) >> (32 - boff))) \
            & 0xFFFFFFFF
        bits = win >> (32 - s)
        code2 = (((code << s) | bits) ^ torch.where(k >= 1, 0x8000, 0)) & U16
        syms[t] = torch.where(active, sym, 0).to(torch.uint8)
        C = torch.where(active[:, None], C2, C)
        cum = torch.where(active, cum2, cum)
        lower = torch.where(active, lo3, lower)
        upper = torch.where(active, up3, upper)
        code = torch.where(active, code2, code)
        bitpos = torch.where(active, bitpos + s, bitpos)
    if not debug:
        return syms
    flags = torch.stack([flag.to(torch.int64),
                         bitpos + 8 * PACKET_HEADER_LENGTH])
    return syms, flags.to(torch.int32)


def packets_to_words(packets: torch.Tensor) -> torch.Tensor:
    """[B, S] uint8 framed packets -> [B, W] int64 big-endian u32 values of
    the bitstream (header stripped, zero-padded to whole words)."""
    body = packets[:, PACKET_HEADER_LENGTH:].to(torch.int64)
    pad = (-body.shape[1]) % 4
    if pad:
        body = torch.nn.functional.pad(body, (0, pad))
    b = body.reshape(body.shape[0], -1, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def encode_packets(data: torch.Tensor, sizes: torch.Tensor, stride: int):
    """Plain K1: data [B, P] uint8, sizes [B] -> (packets [B, stride]
    uint8, lengths [B] int32), on data's device; the bits are packed on
    the host by ``bitpack.pack_batch``."""
    from gpuar_tpu_torch.ops import bitpack

    desc, pat, tail_bit, tail_run = encode_scan(data.T, sizes)

    def lane_major(x):   # [steps, B] with each lane's column contiguous
        return x.T.contiguous().cpu().numpy().T

    packets, lengths = bitpack.pack_batch(
        lane_major(desc), lane_major(pat), tail_bit.cpu().numpy(),
        tail_run.cpu().numpy(), sizes.cpu().numpy(), out_stride=stride)
    return (torch.from_numpy(packets).to(data.device),
            torch.from_numpy(lengths).to(data.device))


def decode_packets(packets: torch.Tensor, raw_sizes: torch.Tensor,
                   packet_size: int, debug: bool = False):
    """Plain K2/K3 on stride-form packets [B, S] uint8 (every byte of a row
    is readable, bytes past it read as zero) -> raw [B, packet_size] uint8
    (zero past raw_size), plus flags [2, B] with ``debug=True``."""
    out = decode_scan(packets_to_words(packets), raw_sizes, packet_size,
                      debug=debug)
    if debug:
        syms, flags = out
        return syms.T.contiguous(), flags
    return out.T.contiguous()


def gather_regions(blob: torch.Tensor, byte_offsets: torch.Tensor,
                   region: int) -> torch.Tensor:
    """Stride rows [B, region] cut from a compacted blob at byte_offsets;
    bytes past the blob's end read as zero (the plain version of K2/K3's
    clamped reads)."""
    idx = byte_offsets.to(torch.int64)[:, None] + torch.arange(
        region, dtype=torch.int64, device=blob.device)[None, :]
    inside = idx < blob.numel()
    rows = blob[idx.clamp(max=max(blob.numel() - 1, 0))]
    return torch.where(inside, rows, torch.zeros((), dtype=torch.uint8,
                                                 device=blob.device))
