"""Command-line driver of the PyTorch/CUDA port.

``python -m gpuar_tpu_torch.cli c|d|v --in=F --out=G [--host] [--device=N]
[--multihost]`` takes the same verbs and flags as ``gpuar_tpu.cli`` (the
reference CLI, jiahansu/GPUAR src/main.cpp:85-96, plus ``v``, ``--resume``,
``--debug`` and ``--deep``).  The codec runs on every local GPU (``--device=N`` pins
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

import argparse
import json
import sys

from gpuar_tpu_torch.utils.stats import ProgressMonitor, SplitTimer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gpuar_tpu_torch.cli",
        description="GPU block-parallel adaptive arithmetic coder (.gip)",
    )
    p.add_argument("mode", nargs="?", default="c", choices=["c", "d", "v"],
                   help="c: compress (default), d: decompress, v: verify "
                        "archive integrity (no output written)")
    p.add_argument("--in", dest="input", required=True, help="input file")
    p.add_argument("--out", dest="output", default="output.gip",
                   help="output file (default output.gip)")
    p.add_argument("--host", action="store_true",
                   help="run the codec on the host CPU (native golden path)")
    p.add_argument("--device", type=int, default=None,
                   help="pin one GPU by index; default: every local GPU")
    p.add_argument("--batch-packets", type=int, default=None,
                   help="packets per super-batch (bounds memory)")
    p.add_argument("--threads", type=int, default=1,
                   help="host-codec worker threads (--host, and v --deep; "
                        "0 = all cores).  Packets are independent, so any "
                        "value yields an identical archive/verdict")
    p.add_argument("--multihost", action="store_true",
                   help="every process codes its file range and splices at "
                        "gathered offsets (shared filesystem)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted compression: complete "
                        "packets already in the output are kept")
    p.add_argument("--debug", action="store_true",
                   help="decompress with the kernel's debug checks: coder "
                        "invariants + bitstream-overrun detection per "
                        "packet; corrupt packets raise instead of decoding "
                        "garbage")
    p.add_argument("--deep", action="store_true",
                   help="with v: also decode every packet on the host "
                        "codec and flag bitstream overruns")
    p.add_argument("--nointeractive", action="store_true",
                   help="suppress progress output")
    p.add_argument("--json", action="store_true",
                   help="print stats as one JSON line")
    return p


def make_compressor(args):
    kwargs = {}
    if args.batch_packets:
        kwargs["super_batch_packets"] = args.batch_packets
    if args.host:
        from gpuar_tpu_torch.pipeline import HostCompressor
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
        from gpuar_tpu_torch.pipeline import verify_archive

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
