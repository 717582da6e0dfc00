"""gpuar_tpu_torch: the PyTorch/CUDA port of gpuar_tpu.

The same codec and ``.gip`` archives as ``gpuar_tpu`` (the JAX package,
which stays the reference), on NVIDIA GPUs: files are split into
independent 8192-byte packets and each super-batch of packets is split
over every local GPU and coded there by hand-written CUDA kernels
(``csrc/``), encode and decode each one thread per packet.
Several processes code one file
together with the CLI's ``--multihost`` (``parallel/distributed.py``,
torch.distributed over gloo); the library calls below run in one process.
The host layer (config, container, the native golden codec, the
pipeline drive loops, the multi-host planners) is the port's own copy of
``gpuar_tpu``'s, under the same names; this package imports ``torch`` and
nothing of ``jax`` or ``gpuar_tpu``.  ``HostCompressor``,
``GPUCompressor``, ``DistributedCompressor`` and ``MeshCodec`` are
importable from the package itself, loaded when first named.
"""

__version__ = "0.1.0"

from gpuar_tpu_torch.config import CodecConfig, DEFAULT_CONFIG  # noqa: F401
from gpuar_tpu_torch.container import ContainerError, FileHeader  # noqa: F401
from gpuar_tpu_torch.utils.stats import (  # noqa: F401
    CompressionInfo,
    ProgressMonitor,
)


def _pick_backend(host: bool, threads: int, debug: bool = False):
    """Every local GPU by default, the native host codec with
    ``host=True``.  Without a CUDA device the GPU backend raises: there is
    no silent fallback."""
    if host:
        from gpuar_tpu_torch.pipeline import HostCompressor
        return HostCompressor(threads=threads)
    from gpuar_tpu_torch.parallel.runner import GPUCompressor
    return GPUCompressor(debug=debug)


def compress(src, dst, *, host: bool = False, threads: int = 1,
             resume: bool = False, monitor=None) -> "CompressionInfo":
    """Compress file ``src`` into .gip archive ``dst`` (CLI ``c``)."""
    return _pick_backend(host, threads).compress(
        src, dst, monitor=monitor, resume=resume)


def decompress(src, dst, *, host: bool = False, threads: int = 1,
               debug: bool = False, monitor=None) -> "CompressionInfo":
    """Decompress .gip archive ``src`` into file ``dst`` (CLI ``d``).
    ``debug=True`` decodes through the debug kernel, which raises on
    corrupt packets; it needs the GPU."""
    if debug and host:
        raise ValueError("debug=True requires the GPU decode path")
    return _pick_backend(host, threads, debug=debug).decompress(
        src, dst, monitor=monitor)


def verify(path, *, deep: bool = False, threads: int = 1) -> dict:
    """Integrity-check a .gip archive (CLI ``v``); see
    pipeline.verify_archive."""
    from gpuar_tpu_torch.pipeline import verify_archive
    return verify_archive(path, deep=deep, threads=threads)


def __getattr__(name):
    # The library classes, imported when first asked for (the JAX
    # package's lazy names; GPUCompressor stands for its TPUCompressor).
    if name == "HostCompressor":
        from gpuar_tpu_torch.pipeline import HostCompressor
        return HostCompressor
    if name == "GPUCompressor":
        from gpuar_tpu_torch.parallel.runner import GPUCompressor
        return GPUCompressor
    if name == "DistributedCompressor":
        from gpuar_tpu_torch.parallel.distributed import DistributedCompressor
        return DistributedCompressor
    if name == "MeshCodec":
        from gpuar_tpu_torch.parallel.mesh import MeshCodec
        return MeshCodec
    raise AttributeError(
        f"module 'gpuar_tpu_torch' has no attribute {name!r}")
