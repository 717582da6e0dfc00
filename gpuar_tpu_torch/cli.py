"""Command-line driver of the PyTorch/CUDA port.

``python -m gpuar_tpu_torch.cli c|d|v --in=F --out=G [--host] [--device=N]
[--multihost]`` takes the same verbs and flags as ``gpuar_tpu.cli`` (its
parser is reused).  The codec runs on every local GPU (``--device=N`` pins
cuda:N); ``--host`` runs the native host codec.  There is no silent
fallback: with no CUDA device and no ``--host`` the command fails and says
so.

``--multihost`` codes one file across a world of processes on a shared
filesystem, over ``torch.distributed`` with the gloo backend.  The world
comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); a configured world that cannot form is
an error, and without ``WORLD_SIZE`` the process runs as a world of one.
"""

from __future__ import annotations

import json
import sys

from gpuar_tpu.cli import build_parser
from gpuar_tpu.utils.stats import ProgressMonitor, SplitTimer


def make_compressor(args):
    kwargs = {}
    if args.batch_packets:
        kwargs["super_batch_packets"] = args.batch_packets
    if args.host:
        from gpuar_tpu.pipeline import HostCompressor
        return HostCompressor(threads=args.threads, **kwargs)
    from gpuar_tpu_torch.parallel.runner import GPUCompressor
    backend = GPUCompressor(device_index=args.device, debug=args.debug,
                            **kwargs)
    if not args.multihost:
        return backend
    from gpuar_tpu_torch.parallel.distributed import DistributedCompressor
    return DistributedCompressor(backend=backend)


def main(argv=None) -> int:
    parser = build_parser()
    parser.prog = "python -m gpuar_tpu_torch.cli"
    args = parser.parse_args(argv)
    if args.host and args.multihost:
        parser.error("--host and --multihost are mutually exclusive")
    if args.resume and args.mode == "d":
        parser.error("--resume only applies to compression (mode 'c')")
    if args.debug and args.mode != "d":
        parser.error("--debug only applies to decompression (mode 'd')")
    if args.debug and args.host:
        parser.error("--debug requires the GPU decode path (drop --host)")
    if args.deep and args.mode != "v":
        parser.error("--deep only applies to verification (mode 'v')")

    if args.mode == "v":
        from gpuar_tpu.pipeline import verify_archive

        try:
            with SplitTimer() as t:
                result = verify_archive(args.input, deep=args.deep,
                                        threads=args.threads)
        except (OSError, ValueError) as e:
            print(str(e), file=sys.stderr)
            return 1
        result["seconds"] = round(t.total, 6)
        if args.json:
            print(json.dumps(result))
        else:
            print(f"{args.input}: OK — {result['packets']} packets, "
                  f"{result['uncompressed_size']} bytes raw, "
                  f"{result['compressed_size']} bytes compressed"
                  f"{' (deep decode verified)' if args.deep else ''}")
        return 0

    if not args.multihost:
        return _run(args)
    import torch.distributed as dist

    from gpuar_tpu_torch.parallel import distributed
    try:
        distributed.initialize()
    except (RuntimeError, ValueError, OSError) as e:
        print(f"Error: the --multihost world did not initialise ({e}).",
              file=sys.stderr)
        return 1
    if distributed.process_info()[1] == 1:
        print("Attention: --multihost with a single process; if other "
              "uncoordinated processes write the same output it will be "
              "corrupted.", file=sys.stderr)
    try:
        return _run(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args) -> int:
    try:
        compressor = make_compressor(args)
    except (RuntimeError, ValueError) as e:
        print(f"Error: GPU codec unavailable ({e}); pass --host to run the "
              "codec on the host CPU.", file=sys.stderr)
        return 1

    monitor = ProgressMonitor(enabled=not args.nointeractive and not args.json)
    try:
        if args.mode == "c":
            if not args.json:
                print(f"Start to compress {args.input} to {args.output}.")
            info = compressor.compress(args.input, args.output, monitor,
                                       resume=args.resume)
        else:
            if not args.json:
                print(f"Start to decompress {args.input} to {args.output}.")
            info = compressor.decompress(args.input, args.output, monitor)
    except (OSError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1

    if args.json:
        print(info.to_json())
        return 0

    print("Complete\n")
    print("Statistics:")
    print(f"Uncompressed file size {info.uncompressed_file_size} bytes")
    print(f"Compressed file size  {info.compressed_file_size} bytes")
    print(f"Compression ratio     {info.ratio:.6g}")
    print(f"Compute time          {info.process_time:.6g} s")
    print(f"I/O time              {info.io_time:.6g} s")
    print(f"Throughput            {info.throughput_gbps:.6g} GB/s")
    print(f"Score                 {info.score:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
