"""K1 wrapper: batch encode of fixed-size raw packets; G1 wrapper: the
batch's ``.gip`` body gathered from K1's rows.

``encode_batch`` is the counterpart of
``gpuar_tpu/ops/pallas_encode.py::encode_batch_pallas`` (the TPU kernel
``_encode_kernel``).  A CUDA tensor goes to the hand-written kernel in
``csrc/encode.cu`` (one packet per thread); a CPU tensor goes to the plain
version ``torch_codec.encode_packets``.

``gather_body`` replaces the JAX package's row compaction and host splice
(``gpuar_tpu/parallel/mesh.py::_compact_rows``, then ``native.splice_at``)
with the port's own kernel G1 (``csrc/gather.cu``): each packet's bytes go
to their byte offset in the body on the card.  A CPU tensor goes to its
plain version ``gather_body_plain``.

Nothing falls back: a CUDA input launches the kernel or raises.
"""

from __future__ import annotations

import torch

from gpuar_tpu_torch.ops import _kernels, torch_codec


def out_geometry(packet_size: int) -> tuple[int, int]:
    """(out_groups, out_words) for a packet size: capacity packet+512+4
    rounded up to a whole 8-word group (the same geometry as
    ``pallas_encode.out_geometry``; 2184 words = 8,736 B at 8192)."""
    cap_words = -(-(packet_size + 512 + 4) // 4)
    groups = -(-cap_words // 8)
    return groups, groups * 8


def _check(data: torch.Tensor, sizes: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be uint8 [B, P], got {data.dtype} "
                         f"{tuple(data.shape)}")
    if sizes.dtype != torch.int32 or sizes.shape != (data.shape[0],):
        raise ValueError(f"sizes must be int32 [{data.shape[0]}], got "
                         f"{sizes.dtype} {tuple(sizes.shape)}")
    if sizes.device != data.device:
        raise ValueError("data and sizes must be on one device")
    if data.shape[1] % 4:
        raise ValueError("packet size must be a multiple of 4 bytes")


def encode_batch(data: torch.Tensor, sizes: torch.Tensor):
    """data uint8 [B, P] (row i holds sizes[i] meaningful bytes), sizes
    int32 [B] -> (packets uint8 [B, out_words*4], lengths int32 [B]).

    The first lengths[i] bytes of row i are the framed packet
    ``[u16 LE total][u16 LE raw][bitstream]``; bytes past it are
    unspecified.
    """
    _check(data, sizes)
    n, packet_size = data.shape
    stride = out_geometry(packet_size)[1] * 4
    if data.device.type == "cpu":
        return torch_codec.encode_packets(data, sizes, stride)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    data = data.contiguous()
    if data.data_ptr() % 16:   # the kernel reads aligned 16-byte words
        data = data.clone()
    sizes = sizes.contiguous()
    packets = torch.empty((n, stride), dtype=torch.uint8, device=data.device)
    lengths = torch.empty(n, dtype=torch.int32, device=data.device)
    launch = _kernels.function("gpuar_encode")
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.check(launch(
            data.data_ptr(), sizes.data_ptr(), n, packet_size,
            packets.data_ptr(), stride, lengths.data_ptr(), stream), "encode")
    _kernels.count("encode", stream)
    return packets, lengths


def gather_body_plain(packets: torch.Tensor, lengths: torch.Tensor):
    """G1's plain version: packets uint8 [n, stride], lengths [n] ->
    (body uint8 [n * stride], total int64 0-d): the first total bytes of
    body are the packets' first lengths[i] bytes back to back (lengths
    clamped to [0, stride]); the bytes past them are zero."""
    n, stride = packets.shape
    keep = torch.arange(stride, device=packets.device)[None, :] \
        < lengths.to(torch.int64)[:, None]
    dense = packets[keep]
    body = torch.zeros(n * stride, dtype=torch.uint8, device=packets.device)
    body[: dense.numel()] = dense
    return body, torch.tensor(dense.numel(), dtype=torch.int64,
                              device=packets.device)


def gather_body(packets: torch.Tensor, lengths: torch.Tensor):
    """K1's packets uint8 [n, stride] and lengths [n] (each in [0, stride],
    as K1's are) -> (body uint8 [n * stride], total int64 0-d), both on
    packets' device and without a host sync: the first total bytes of
    body are the ``.gip`` body of the batch, packet i at the sum of the
    lengths before it; the bytes past them are unspecified.  One cumsum
    of the lengths on the device gives the offsets; G1 copies the
    bytes."""
    if packets.dtype != torch.uint8 or packets.dim() != 2:
        raise ValueError(f"packets must be uint8 [n, stride], got "
                         f"{packets.dtype} {tuple(packets.shape)}")
    if lengths.shape != (packets.shape[0],) or lengths.device != packets.device:
        raise ValueError(f"lengths must be [{packets.shape[0]}] on "
                         f"{packets.device}, got {tuple(lengths.shape)} on "
                         f"{lengths.device}")
    if packets.device.type == "cpu":
        return gather_body_plain(packets, lengths)
    if packets.device.type != "cuda":
        raise ValueError(f"unsupported device {packets.device}")
    n, stride = packets.shape
    packets = packets.contiguous()
    body = torch.empty(n * stride, dtype=torch.uint8, device=packets.device)
    if n == 0:
        return body, torch.zeros((), dtype=torch.int64, device=packets.device)
    ends = torch.cumsum(lengths, 0, dtype=torch.int64)
    launch = _kernels.function("gpuar_gather_body")
    with torch.cuda.device(packets.device):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.check(launch(packets.data_ptr(), stride, ends.data_ptr(), n,
                              body.data_ptr(), stream), "gather")
    _kernels.count("gather", stream)
    return body, ends[-1]
