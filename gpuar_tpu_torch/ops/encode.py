"""K1 wrapper: batch encode of fixed-size raw packets.

The counterpart of ``gpuar_tpu/ops/pallas_encode.py::encode_batch_pallas``
(the TPU kernel ``_encode_kernel``).  A CUDA tensor goes to the
hand-written kernel in ``csrc/encode.cu``; a CPU tensor goes to the plain
version ``torch_codec.encode_packets``.  Nothing falls back: a CUDA input
launches the kernel or raises.
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

