"""Run the probes on the first GPU at their own sizes.

    python -m gpuar_tpu_torch.probes [model] [carry] [encode] [layouts]

Each probe prints what its ``benchmarks/`` script printed, one line per
variant, level or primitive, with the card's name and power limit:

  * model (P1): ms and ns per step of every variant, STEPS 8192 x REPEAT 8
    steps per chain, at each width of ``probe_model.TILES`` (the probe's
    512 chains and 8192, one K1 batch);
  * carry (P2): ms and ns per iteration of each carry configuration, at
    the same widths;
  * encode (P3): ms, GB/s of raw bytes and ns per step (all packets
    advancing one step) of levels 1-5 on B 4096 packets of 8192 random
    bytes, then K1's time on the same bytes, the whole encoder the levels
    break down;
  * layouts (P4): ms and GB/s-equivalent (STEPS x tables / time) of each
    primitive, the table probes at each width of ``probe_layouts.TABLES``
    (the probe's 1024 tables and 8192, one K1 batch).

Times are the least of three CUDA-event timings after one untimed launch.
With no probe named, all four run.  There is no CPU fallback: without a
CUDA device the command fails.
"""

from __future__ import annotations

import argparse
import sys

import torch

from gpuar_tpu_torch import probes
from gpuar_tpu_torch.probes import probe_layouts, probe_model, profile_encode

ALL = ("model", "carry", "encode", "layouts")


def _model(dev, card, carry: bool) -> list[dict]:
    steps, repeat = probe_model.STEPS, probe_model.REPEAT
    out, inputs = [], {}
    for tile in probe_model.TILES:
        for name in (probe_model.CARRIES if carry else probe_model.VARIANTS):
            rows = steps // 4 if carry else probe_model.input_rows(name, steps)
            if (rows, tile) not in inputs:
                inputs[rows, tile] = torch.from_numpy(
                    probe_model.make_words(rows, tile)).to(dev)
            words = inputs[rows, tile]
            if carry:
                run = lambda: probe_model.carry(  # noqa: E731
                    words, name, steps * repeat)
            else:
                run = lambda: probe_model.model(  # noqa: E731
                    words, name, steps, repeat)
            ms = probes.time_ms(run)
            unit = "ns/iter" if carry else "ns/step"
            print(f"[{card}] {'P2 carry' if carry else 'P1'} {name:24s} "
                  f"{tile:5d} chains {ms:10.4f} ms "
                  f"{ms * 1e6 / (steps * repeat):9.3f} {unit}", flush=True)
            out.append({"probe": "P2" if carry else "P1", "name": name,
                        "width": tile, "ms": ms, "words": words,
                        "out": run()})
    return out


def _encode(dev, card) -> list[dict]:
    from gpuar_tpu_torch.ops import encode

    n, steps = profile_encode.B, profile_encode.STEPS
    words = torch.from_numpy(probe_model.make_words(steps // 4, n)).to(dev)
    sizes = torch.full((n,), steps, dtype=torch.int32, device=dev)
    out = []

    def line(name, ms):
        print(f"[{card}] P3 {name:24s} {ms:10.4f} ms "
              f"{n * steps / ms / 1e6:8.3f} GB/s {ms * 1e6 / steps:9.3f} "
              f"ns/step ({n} packets x {steps} B)", flush=True)

    for level in profile_encode.LEVELS:
        run = lambda: profile_encode.profile(  # noqa: E731
            words, sizes, level, steps)
        ms = probes.time_ms(run)
        line(f"L{level}", ms)
        out.append({"probe": "P3", "name": f"L{level}", "width": n, "ms": ms,
                    "words": words, "sizes": sizes, "out": run()})
    # K1 on the same bytes: packet b is column b of the words.
    data = words.T.contiguous().view(torch.uint8)
    ms = probes.time_ms(lambda: encode.encode_batch(data, sizes))
    line("K1 (the whole encoder)", ms)
    out.append({"probe": "P3", "name": "K1", "width": n, "ms": ms})
    return out


def _layouts(dev, card) -> list[dict]:
    steps = probe_layouts.STEPS
    seed = torch.from_numpy(probe_layouts.make_seed()).to(dev)
    runs = [(name, seed.numel(), lambda name=name: probe_layouts.scalar(
        seed, name, steps)) for name in probe_layouts.SCALAR]
    runs += [(name, n, lambda name=name, n=n: probe_layouts.table(
        seed, name, n, steps))
        for n in probe_layouts.TABLES for name in probe_layouts.TABLE]
    out = []
    for name, n, run in runs:
        ms = probes.time_ms(run)
        print(f"[{card}] P4 {probe_layouts.NAMES[name]:36s} {n:5d} "
              f"{ms:10.4f} ms {steps * n / ms / 1e6:9.3f} GBps-eq",
              flush=True)
        out.append({"probe": "P4", "name": name, "width": n, "ms": ms,
                    "seed": seed, "out": run()})
    return out


def main(argv=None) -> list[dict]:
    """Run the named probes (default all) -> one dict per line printed:
    probe, name, width, ms, the inputs and the output."""
    p = argparse.ArgumentParser(prog="python -m gpuar_tpu_torch.probes",
                                description=__doc__.splitlines()[0])
    p.add_argument("probes", nargs="*", metavar="{model,carry,encode,layouts}")
    args = p.parse_args(argv)
    if set(args.probes) - set(ALL):
        p.error(f"unknown probe(s) {sorted(set(args.probes) - set(ALL))}")
    if not torch.cuda.is_available():
        raise SystemExit("gpuar_tpu_torch.probes: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    card = probes.card()
    results = []
    for name in args.probes or ALL:
        if name in ("model", "carry"):
            results += _model(dev, card, carry=name == "carry")
        elif name == "encode":
            results += _encode(dev, card)
        else:
            results += _layouts(dev, card)
    return results


if __name__ == "__main__":
    main()
