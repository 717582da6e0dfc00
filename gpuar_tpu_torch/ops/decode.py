"""K2/K3 wrappers: batch decode of framed packets.

The counterpart of ``gpuar_tpu/ops/pallas_decode.py::decode_batch_pallas``
(the TPU kernel ``_decode_kernel``; ``debug=True`` is K3).  A CUDA tensor
goes to the hand-written kernel in ``csrc/decode.cu``; a CPU tensor goes
to the plain version ``torch_codec.decode_packets``.  Nothing falls back:
a CUDA input launches the kernel or raises.

Two input forms, one kernel:

* ``decode_batch`` takes the stride form, packets [B, S] with packet i in
  row i (what ``_PacketReader.read_batch`` returns);
* ``decode_blob`` takes the compacted form, one byte blob with packet i at
  ``byte_offsets[i]`` (what ``_PacketReader.read_batch_blob`` returns,
  with offsets = row offsets * row bytes).

Either way a packet's readable window is its first ``out_words*4`` bytes
(the stride the TPU kernel reads), clipped to the input; bytes past it
read as zero.
"""

from __future__ import annotations

import numpy as np
import torch

from gpuar_tpu_torch import container
from gpuar_tpu_torch.config import UNCOMPRESSED_PACKET_SIZE
from gpuar_tpu_torch.ops import _kernels, torch_codec
from gpuar_tpu_torch.ops.encode import out_geometry


def check_debug_flags(flags: np.ndarray, comp_len: np.ndarray,
                      n: int) -> None:
    """Raise ContainerError for packets whose debug flags fired.

    A copy of ``pallas_decode.check_debug_flags`` (same rule, same
    message).  Row 0: in-kernel invariant violations (the reference's
    -D_DEBUG checks).  Row 1: final bit cursor, compared against the framed
    packet length (``comp_len`` bytes): the decoder legitimately reads up
    to 16 lookahead bits past the written stream, so anything beyond +16
    means the stream ran dry, the signature of a corrupt well-framed
    packet.
    """
    flags = np.asarray(flags)
    overrun = flags[1, :n] > np.asarray(comp_len, np.int64)[:n] * 8 + 16
    bad = np.nonzero((flags[0, :n] != 0) | overrun)[0]
    if bad.size:
        raise container.ContainerError(
            "Corrupt packet data: coder invariant violation or "
            f"bitstream overrun in packets {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''}"
        )


def _check_sizes(raw_sizes: torch.Tensor, n: int, device) -> None:
    if raw_sizes.dtype != torch.int32 or raw_sizes.shape != (n,):
        raise ValueError(f"raw_sizes must be int32 [{n}], got "
                         f"{raw_sizes.dtype} {tuple(raw_sizes.shape)}")
    if raw_sizes.device != device:
        raise ValueError("all inputs must be on one device")


def _launch(blob, byte_offsets, region, raw_sizes, packet_size, debug):
    """One K2 (or K3) launch over a blob; every input is on the card."""
    n = raw_sizes.shape[0]
    dev = blob.device
    out = torch.empty((n, packet_size), dtype=torch.uint8, device=dev)
    flags = torch.empty((2, n), dtype=torch.int32, device=dev) if debug \
        else None
    blob = blob.contiguous()
    byte_offsets = byte_offsets.contiguous()
    raw_sizes = raw_sizes.contiguous()
    launch = _kernels.function("gpuar_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.check(launch(
            blob.data_ptr(), blob.numel(), byte_offsets.data_ptr(), region,
            raw_sizes.data_ptr(), n, packet_size, out.data_ptr(),
            flags.data_ptr() if debug else None, int(debug), stream),
            "decode")
    _kernels.count("decode_debug" if debug else "decode", stream)
    return (out, flags) if debug else out


def decode_batch(packets: torch.Tensor, raw_sizes: torch.Tensor, *,
                 packet_size: int = UNCOMPRESSED_PACKET_SIZE,
                 debug: bool = False):
    """Stride form: packets uint8 [B, S], raw_sizes int32 [B] -> raw uint8
    [B, packet_size] (zero past raw_sizes[i]); with ``debug=True`` returns
    (raw, flags int32 [2, B]) for ``check_debug_flags``."""
    if packets.dtype != torch.uint8 or packets.dim() != 2:
        raise ValueError(f"packets must be uint8 [B, S], got "
                         f"{packets.dtype} {tuple(packets.shape)}")
    n, width = packets.shape
    _check_sizes(raw_sizes, n, packets.device)
    region = min(width, out_geometry(packet_size)[1] * 4)
    if packets.device.type == "cpu":
        return torch_codec.decode_packets(packets[:, :region], raw_sizes,
                                          packet_size, debug=debug)
    if packets.device.type != "cuda":
        raise ValueError(f"unsupported device {packets.device}")
    offsets = torch.arange(n, dtype=torch.int64,
                           device=packets.device) * width
    return _launch(packets.contiguous().view(-1), offsets, region, raw_sizes,
                   packet_size, debug)


def decode_blob(blob: torch.Tensor, byte_offsets: torch.Tensor,
                raw_sizes: torch.Tensor, *,
                packet_size: int = UNCOMPRESSED_PACKET_SIZE,
                debug: bool = False):
    """Compacted form: blob uint8 [L], byte_offsets int64 [B] (packet i
    starts at blob[byte_offsets[i]]), raw_sizes int32 [B] -> as
    ``decode_batch``."""
    if blob.dtype != torch.uint8 or blob.dim() != 1:
        raise ValueError(f"blob must be uint8 [L], got {blob.dtype} "
                         f"{tuple(blob.shape)}")
    n = raw_sizes.shape[0] if raw_sizes.dim() == 1 else -1
    _check_sizes(raw_sizes, n, blob.device)
    if byte_offsets.dtype != torch.int64 or byte_offsets.shape != (n,) \
            or byte_offsets.device != blob.device:
        raise ValueError(f"byte_offsets must be int64 [{n}] on the blob's "
                         "device")
    region = out_geometry(packet_size)[1] * 4
    if blob.device.type == "cpu":
        rows = torch_codec.gather_regions(blob, byte_offsets, region)
        return torch_codec.decode_packets(rows, raw_sizes, packet_size,
                                          debug=debug)
    if blob.device.type != "cuda":
        raise ValueError(f"unsupported device {blob.device}")
    return _launch(blob, byte_offsets, region, raw_sizes, packet_size, debug)
