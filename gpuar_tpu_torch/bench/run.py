"""The corpus table and the file end-to-end rows on the card (the
counterpart of ``benchmarks/run.py``).

    python -m gpuar_tpu_torch.bench.run [--mib 64] [--skip-e2e] [--out PATH]

For each corpus, ``--mib`` MiB of it:

  * random: uniform random bytes, seed 0xBE7C (GPUAR's README corpus;
    ratio about 1, every packet at full stride);
  * enwik-proxy: ``corpora.generate``, the pinned enwik8 stand-in;
  * text: the checkout's own source and documentation files, in sorted
    order, repeated to the size;
  * utf8-text: ``corpora.generate_utf8``, mixed high and low bytes;
  * zeros: the degenerate best case;

the kernel layer of ``python -m gpuar_tpu_torch.bench``: K1 on every 64 MiB
super-batch already on the card, every packet equal to the golden codec
and ``SPEC_SAMPLE`` of them to the executable specification (the bench's
cells hold 256; the table keeps to a few, which need no process pool),
K2 back to the bytes, each timed by CUDA events (least of 3); encode and
decode GB/s are the corpus bytes over the summed least times.  Then,
unless ``--skip-e2e``, two rows of the whole file pipeline
(``GPUCompressor().compress`` / ``.decompress`` of a file, warmed on the
same file first, one timed run, md5 round trip) for random and
enwik-proxy, with ``CompressionInfo``'s process/io split.  Prints a
markdown table beside the card's name and power limit, and writes the
rows as JSON to ``--out`` (default ``_bench/run_results.json`` in the
package, git-ignored).  ``main`` takes the device as an argument too:
the tests pass the CPU, where the kernels' plain versions run and no
rate is reported.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from gpuar_tpu_torch.bench import OUT, corpora, md5

ROOT = Path(__file__).resolve().parents[2]   # holds gpuar_tpu_torch/
TEXT_DIRS = ("gpuar_tpu_torch", "gpuar_tpu", "tests", "benchmarks")
TEXT_SUFFIXES = (".py", ".md", ".cu", ".cuh", ".cpp", ".json", ".toml")
SPEC_SAMPLE = 8   # packets a super-batch held to ops/golden.py


def text_corpus(size: int) -> bytes:
    """The checkout's text files (root *.md, then TEXT_DIRS, sorted, build
    and output directories skipped), repeated to ``size`` bytes."""
    files = sorted(ROOT.glob("*.md"))
    for d in TEXT_DIRS:
        files += sorted(p for p in (ROOT / d).rglob("*")
                        if p.suffix in TEXT_SUFFIXES and p.is_file()
                        and not any(part.startswith("_")
                                    for part in p.relative_to(ROOT).parts))
    out = bytearray()
    for p in files:
        if len(out) >= size:
            break
        out += p.read_bytes()
    if not out:
        out += b"the quick brown fox! "
    while len(out) < size:
        out += out[: size - len(out)]
    return bytes(out[:size])


def corpus_list(mib: float):
    size = int(mib * (1 << 20))
    yield "random", corpora.random_bytes(size)
    yield "enwik-proxy", corpora.cached("enwik", size)
    yield "text", text_corpus(size)
    yield "utf8-text", corpora.cached("utf8", size)
    yield "zeros", bytes(size)


def bench_corpus(name: str, data: bytes, device: torch.device,
                 host) -> dict:
    """The kernel layer on one corpus (``bench.__main__.kernel_layer``,
    least of 3) -> its table row."""
    from gpuar_tpu_torch.bench.__main__ import kernel_layer

    rows = kernel_layer(data, device, host, reps=3,
                        golden_sample=SPEC_SAMPLE)
    total = len(data)
    timed = device.type == "cuda"   # the CPU's plain versions are untimed

    def gbps(key):
        return round(total / sum(r[key] for r in rows) / 1e6, 4) \
            if timed else None

    return {
        "corpus": name,
        "mib": total >> 20,
        "encode_gbps": gbps("k1_ms"),
        "decode_gbps": gbps("k2_ms"),
        "ratio": round((sum(r["comp_bytes"] for r in rows) + 20) / total, 6),
        "roundtrip": "bit-exact, every packet golden",
        "k1_ms": [r["k1_ms"] for r in rows] if timed else None,
        "k2_ms": [r["k2_ms"] for r in rows] if timed else None,
    }


def bench_file_level(data: bytes, name: str, gpu, work: Path) -> dict:
    """The file pipeline on ``data``: a warm run on the same file, then one
    timed compress and decompress, md5 round trip -> its table row."""
    src, gip, back = work / "in.bin", work / "c.gip", work / "back.bin"
    src.write_bytes(data)
    gpu.compress(src, work / "w.gip")
    gpu.decompress(work / "w.gip", work / "w.bin")
    t0 = time.perf_counter()
    ci = gpu.compress(src, gip)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    di = gpu.decompress(gip, back)
    t_d = time.perf_counter() - t0
    assert md5(src) == md5(back), "file-level round-trip mismatch"
    size = len(data)
    return {
        "corpus": f"file-e2e ({name})",
        "mib": size >> 20,
        "encode_gbps": round(size / t_c / 1e9, 4),
        "decode_gbps": round(size / t_d / 1e9, 4),
        "ratio": round(ci.compressed_file_size / size, 6),
        "roundtrip": "md5-exact",
        "compress_process_s": round(ci.process_time, 3),
        "compress_io_s": round(ci.io_time, 3),
        "decompress_process_s": round(di.process_time, 3),
        "decompress_io_s": round(di.io_time, 3),
    }


def main(argv=None, device: torch.device | None = None) -> list[dict]:
    """The command; ``device`` (default cuda:0, which must exist) is where
    the corpus rows' kernels run."""
    ap = argparse.ArgumentParser(prog="python -m gpuar_tpu_torch.bench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=float, default=64)
    ap.add_argument("--skip-e2e", action="store_true",
                    help="the corpus table alone, without the file "
                         "end-to-end rows")
    ap.add_argument("--out", default=str(OUT / "run_results.json"),
                    help="where the rows go as JSON")
    args = ap.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("gpuar_tpu_torch.bench.run: no CUDA device "
                             "(torch.cuda.is_available() is false)")
        device = torch.device("cuda", 0)
    from gpuar_tpu_torch.parallel.runner import GPUCompressor
    from gpuar_tpu_torch.pipeline import HostCompressor
    from gpuar_tpu_torch.probes import card as card_of

    card = card_of()
    host = HostCompressor(threads=0)
    rows, data_of = [], {}
    for name, data in corpus_list(args.mib):
        rows.append(bench_corpus(name, data, device, host))
        if name in ("random", "enwik-proxy"):
            data_of[name] = data
        print(f"done: {rows[-1]}", flush=True)
    if not args.skip_e2e:
        OUT.mkdir(parents=True, exist_ok=True)
        gpu = GPUCompressor()
        for name in ("random", "enwik-proxy"):
            with tempfile.TemporaryDirectory(dir=OUT) as work:
                rows.append(bench_file_level(data_of[name], name, gpu,
                                             Path(work)))
            print(f"done: {rows[-1]}", flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=2))
    print(f"\n{card}\n")
    print("| corpus | size | encode GB/s | decode GB/s | ratio | round-trip |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['corpus']} | {r['mib']} MiB | {r['encode_gbps']} | "
              f"{r['decode_gbps']} | {r['ratio']} | {r['roundtrip']} |")
    return rows


if __name__ == "__main__":
    main()
