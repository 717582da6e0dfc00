"""The port's measurement harnesses (``gpuar_tpu_torch.bench.run``,
``soak``, ``bigfile``, ``scaling``, ``sleep_backend``) on the CPU.

Each copy is held to its original in ``benchmarks/`` at 0 bytes: the
soak's corpus for a seed, and the sleep control's packets and decode.
The three tests of ``tests/test_sleep_backend.py`` run on the port's
copy.  Then the harnesses run at a few packets: the soak through
HostCompressor and ``GPUCompressor(devices=[cpu])`` (the kernels' plain
versions), the underflow adversary and debug decode included; bigfile at
8 MiB with ``--host`` and the 4 GiB check off; scaling at worlds 1 and 2
with the host and sleep backends over gloo, compress and decompress (the
decoded file checked), its sizing arithmetic held to
``benchmarks/scaling.py``'s; ``run``'s file row, text corpus and table
without the file rows (``--skip-e2e``).  The GPU-marked tests run
``run``'s kernel row and the GPU decompress scaling on the card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import soak as jax_soak
from benchmarks.sleep_backend import SleepCompressor as JaxSleep
from gpuar_tpu_torch.bench import corpora, md5, run, scaling, soak
from gpuar_tpu_torch.bench.sleep_backend import SleepCompressor
from gpuar_tpu_torch.config import (
    COMPRESSED_PACKET_SIZE,
    PACKET_HEADER_LENGTH,
    UNCOMPRESSED_PACKET_SIZE,
)
from gpuar_tpu_torch.parallel.runner import GPUCompressor
from gpuar_tpu_torch.pipeline import HostCompressor

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
P = UNCOMPRESSED_PACKET_SIZE


@pytest.mark.parametrize("size", [0, 1, 8193, 5 << 20])
def test_make_corpus_equals_jax(size):
    a, b = np.random.default_rng(0xF00D), np.random.default_rng(0xF00D)
    assert soak.make_corpus(a, size) == jax_soak.make_corpus(b, size)
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


def test_sleep_backend_equals_jax(rng):
    raw = rng.integers(0, 256, 5 * P + 777, np.uint8)
    ours, theirs = SleepCompressor(gbps=100.0), JaxSleep(gbps=100.0)
    pk, ln = ours.encode_fetch(ours.encode_submit(raw))
    jpk, jln = theirs.encode_fetch(theirs.encode_submit(raw))
    np.testing.assert_array_equal(pk, jpk)
    np.testing.assert_array_equal(ln, jln)
    sizes = np.array([P] * 5 + [777], np.int64)
    np.testing.assert_array_equal(
        ours.decode_fetch(ours.decode_submit(pk, sizes)),
        theirs.decode_fetch(theirs.decode_submit(jpk, sizes)))


def test_sleep_backend_framing(rng):
    raw = rng.integers(0, 256, 3 * P + 1234, np.uint8)
    be = SleepCompressor(gbps=100.0)
    packets, lengths = be.encode_fetch(be.encode_submit(raw))
    assert packets.shape == (4, COMPRESSED_PACKET_SIZE)
    # Headers parse like the real container: [u16 total][u16 raw size].
    for i in range(4):
        total = int(packets[i, 0]) | int(packets[i, 1]) << 8
        rsize = int(packets[i, 2]) | int(packets[i, 3]) << 8
        expect_raw = P if i < 3 else 1234
        assert total == lengths[i] == PACKET_HEADER_LENGTH + expect_raw
        assert rsize == expect_raw
        body = packets[i, 4: 4 + rsize]
        assert np.array_equal(body, raw[i * P: i * P + rsize])

    # Stored round-trip through the decode side.
    raw_sizes = np.array([P, P, P, 1234], np.int64)
    out = be.decode_fetch(be.decode_submit(packets, raw_sizes))
    flat = np.concatenate([out[i, :raw_sizes[i]] for i in range(4)])
    assert np.array_equal(flat, raw)


def test_sleep_backend_sleeps_not_burns(rng):
    raw = rng.integers(0, 256, 2 * P, np.uint8)
    be = SleepCompressor(gbps=0.001)  # 2*8192 bytes -> ~16 ms deadline
    t0 = time.perf_counter()
    h = be.encode_submit(raw)
    be.encode_fetch(h)
    elapsed = time.perf_counter() - t0
    assert elapsed >= 0.014, f"deadline not honoured: {elapsed}"


def test_sleep_backend_serializes_device_time(rng):
    # A real device queues submitted batches: two in-flight batches must
    # cost the SUM of their device times, not the max (a concurrent-sleep
    # control would emulate a 2x-throughput device under submit-ahead and
    # skew whichever world size pipelines deeper).
    raw = rng.integers(0, 256, 2 * P, np.uint8)
    be = SleepCompressor(gbps=0.001)  # ~16 ms per 2-packet batch
    t0 = time.perf_counter()
    h1 = be.encode_submit(raw)
    h2 = be.encode_submit(raw)
    be.encode_fetch(h1)
    be.encode_fetch(h2)
    assert time.perf_counter() - t0 >= 0.028


def test_soak_host_and_plain_gpu_path(tmp_path):
    """Edge sizes 0, 1 and 300, then the underflow adversary's iteration
    (a file of at most 9000 B), then debug decode of 3 packets: the GPU
    path on the CPU equals the host archive and decodes it."""
    rng = np.random.default_rng(0xF00D)
    host = HostCompressor()
    rows = soak.soak(4, rng, host, tmp_path,
                     gpu=GPUCompressor(devices=[CPU]),
                     edge_sizes=(0, 1, 300), max_size=9000)
    assert [r["adversary"] for r in rows] == [False] * 3 + [True]
    assert all(r["ok"] for r in rows)
    adv = corpora.adversarial_underflow_packet().tobytes()
    assert (tmp_path / "in.bin").read_bytes()[:len(adv)] == adv
    got = soak.debug_decode(host, GPUCompressor(devices=[CPU]),
                            GPUCompressor(devices=[CPU], debug=True),
                            tmp_path, rng, packets=3)
    assert got == {"clean_ok": True, "corrupt_raised": True,
                   "release_decodes_garbage": True}


def test_soak_command_host_only(tmp_path):
    out = tmp_path / "soak.json"
    r = subprocess.run([sys.executable, "-m", "gpuar_tpu_torch.bench.soak",
                        "--host-only", "--iters", "6", "--json", str(out)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(out.read_text())
    assert [row["bytes"] for row in got["iters"]] == \
        list(soak.EDGE_SIZES[:6])
    assert got["backend"] == "host-only" and got["debug_decode"] is None


def _bigfile(tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "gpuar_tpu_torch.bench.bigfile", "--host",
         f"--gib={8 / 1024}", f"--kill-at={1 << 20}", "--batch-packets=1",
         f"--tmp={tmp_path}", *args], cwd=REPO, capture_output=True,
        text=True, timeout=300)


def test_bigfile_at_8_mib_on_the_host(tmp_path):
    """Super-batches of one packet write the archive in 1028 steps, so the
    kill lands after 1 MiB and long before the end."""
    out = tmp_path / "big.json"
    r = _bigfile(tmp_path, "--min-archive=0", f"--json={out}")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    res = json.loads(out.read_text())
    assert res["bytes"] == (8 << 20) + 12345
    assert (1 << 20) < res["interrupted_at_bytes"] < res["compressed_bytes"]
    assert res["match"] is True and res["md5_back"] == res["md5"]
    assert res["backend"] == "host"


def test_bigfile_keeps_the_4gib_check(tmp_path):
    r = _bigfile(tmp_path)   # --min-archive defaults to 2**32
    assert r.returncode != 0
    assert "u64 field proof" in r.stderr


@pytest.mark.parametrize("backend", ["host", "sleep"])
def test_scaling_worlds_1_and_2_over_gloo(tmp_path, backend):
    args = ["--backend", backend, "--worlds", "1,2", "--per-host-mib", "1",
            "--tmpdir", str(tmp_path), "--json", str(tmp_path / "s.json")]
    if backend == "sleep":
        args += ["--chip-gbps", "0.5"]
    out = scaling.main(args)
    assert json.loads((tmp_path / "s.json").read_text()) == out
    # The JSON shape of benchmarks/scaling.py.
    assert set(out) == {"metric", "mode", "backend", "per_host_bytes",
                        "emulated_gib_per_host", "shared_machine",
                        "chip_gbps_assumed", "worlds"}
    assert [w["world"] for w in out["worlds"]] == [1, 2]
    for w in out["worlds"]:
        assert set(w) == {"world", "wall", "coord", "process", "io",
                          "cpu_total", "wall_efficiency",
                          "serialized_efficiency", "projected_efficiency",
                          "projected_efficiency_1gib_per_host"}
        assert w["wall"] > 0
    assert out["worlds"][0]["wall_efficiency"] == 1.0
    assert out["emulated_gib_per_host"] is None
    if backend == "sleep":
        # 1 MiB at 0.5 GB/s sleeps about 2 ms a rank.
        assert all(0 < w["projected_efficiency"] <= 1 for w in out["worlds"])
    else:
        assert out["chip_gbps_assumed"] is None
        assert out["worlds"][1]["projected_efficiency"] is None


def test_scaling_sleep_needs_a_card_rate():
    with pytest.raises(SystemExit) as e:
        scaling.main(["--backend", "sleep"])
    assert e.value.code == 2


def test_run_text_corpus_and_file_row(tmp_path):
    text = run.text_corpus(1 << 20)
    assert len(text) == 1 << 20 and text == run.text_corpus(1 << 20)
    row = run.bench_file_level(corpora.generate(3000), "enwik-proxy",
                               GPUCompressor(devices=[CPU]), tmp_path)
    assert row["corpus"] == "file-e2e (enwik-proxy)"
    assert row["roundtrip"] == "md5-exact"
    assert md5(tmp_path / "in.bin") == md5(tmp_path / "back.bin")


@pytest.mark.gpu
def test_gpu_run_corpus_row_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    row = run.bench_corpus("enwik-proxy", corpora.generate(2 << 20),
                           torch.device("cuda", 0), HostCompressor(threads=0))
    assert row["encode_gbps"] > 0 and row["decode_gbps"] > 0
    assert 0.4 < row["ratio"] < 0.75


JAX_KEYS = {"metric", "mode", "backend", "per_host_bytes",
            "emulated_gib_per_host", "shared_machine", "chip_gbps_assumed",
            "worlds"}
WORLD_KEYS = {"world", "wall", "coord", "process", "io", "cpu_total",
              "wall_efficiency", "serialized_efficiency",
              "projected_efficiency", "projected_efficiency_1gib_per_host"}


@pytest.mark.parametrize("backend", ["host", "sleep"])
def test_scaling_decompress_worlds_1_and_2_over_gloo(tmp_path, backend):
    """--mode d: every rank compresses, then the decompress is timed; the
    harness raises unless the decoded file equals the input."""
    args = ["--backend", backend, "--mode", "d", "--worlds", "1,2",
            "--per-host-mib", "0.5", "--tmpdir", str(tmp_path)]
    if backend == "sleep":
        args += ["--chip-gbps", "0.5"]
    out = scaling.main(args)
    assert out["mode"] == "d" and out["backend"] == backend
    assert set(out) == JAX_KEYS
    assert [w["world"] for w in out["worlds"]] == [1, 2]
    for w in out["worlds"]:
        assert set(w) == WORLD_KEYS and w["wall"] > 0
    assert list(tmp_path.iterdir()) == []   # the worlds' files are gone


def test_scaling_decompress_checks_the_round_trip(tmp_path, monkeypatch):
    """A rank whose decode flips every bit 0 fails the world."""
    monkeypatch.setattr(scaling, "RUN_WORKER", (
        "import sys; import numpy as np; "
        "from gpuar_tpu_torch.pipeline import Compressor; "
        "real = Compressor.decode_fetch; "
        "Compressor.decode_fetch = lambda self, h: real(self, h) ^ "
        "np.uint8(1); "
        "from gpuar_tpu_torch.bench import scaling; "
        "scaling.worker(*sys.argv[1:])"))
    with pytest.raises(RuntimeError, match="decoded file differs"):
        scaling.run_world(1, 1 << 16, "host", tmpdir=str(tmp_path), mode="d")


def test_scaling_emulation_and_sizing_equal_jax():
    """``benchmarks/scaling.py``'s arithmetic: time_scale = G GiB / per-host
    bytes, t_chip of G GiB, and the sleep super-batch
    max(per_host // max(N, 1) // 8192, 1)."""
    for per_host in (1 << 16, 4 << 20, 32 << 20, 12345678):
        for n in (0, 1, 16, 100, 10_000):
            assert scaling.sleep_super_batch(per_host, n) == \
                max(per_host // max(n, 1) // P, 1)
        for g in (0.01, 1.0, 2.5):
            scale, t_chip = scaling.emulation(g, per_host, 0.4)
            assert scale == g * (1 << 30) / per_host
            assert t_chip == g * (1 << 30) / (0.4 * 1e9)


def test_scaling_main_passes_the_sizing_and_keeps_the_least_wall(
        monkeypatch, capsys):
    """--segments-per-host and --emulate-gib reach each world as JAX
    computes them; --reps 2 keeps the run with the least wall."""
    calls = []
    walls = iter([3.0, 1.0, 5.0, 2.0])

    def fake(world, per_host, backend, **kw):
        calls.append((world, per_host, backend, kw))
        return {"world": world, "wall": next(walls), "coord": 0.1,
                "process": 0.5, "io": 0.2, "cpu_total": 0.3}

    monkeypatch.setattr(scaling, "run_world", fake)
    out = scaling.main(["--backend", "sleep", "--mode", "d", "--worlds",
                        "1,2", "--per-host-mib", "4", "--emulate-gib",
                        "0.01", "--segments-per-host", "8", "--reps", "2",
                        "--chip-gbps", "0.5"])
    per_host = 4 << 20
    assert [c[0] for c in calls] == [1, 1, 2, 2]
    for _, ph, backend, kw in calls:
        assert (ph, backend, kw["mode"]) == (per_host, "sleep", "d")
        assert kw["sleep_sbp"] == per_host // 8 // P == 64
        assert kw["time_scale"] == 0.01 * (1 << 30) / per_host
        assert kw["chip_gbps"] == 0.5
    assert [w["wall"] for w in out["worlds"]] == [1.0, 2.0]
    assert out["emulated_gib_per_host"] == 0.01
    t_chip = 0.01 * (1 << 30) / 0.5e9
    assert out["worlds"][1]["projected_efficiency"] == t_chip / (t_chip + 0.1)
    assert out["worlds"][1]["wall_efficiency"] == 0.5
    assert "(min of 2)" in capsys.readouterr().out

    calls.clear()
    walls = iter([1.0])
    scaling.main(["--backend", "host", "--worlds", "1"])
    assert calls[0][3]["sleep_sbp"] == 8192 and \
        calls[0][3]["time_scale"] == 1.0


def test_scaling_emulate_gib_needs_the_sleep_backend():
    with pytest.raises(SystemExit) as e:
        scaling.main(["--backend", "host", "--emulate-gib", "1"])
    assert e.value.code == 2


def test_scaling_defaults_to_the_gpu_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs")
    with pytest.raises(SystemExit) as e:
        scaling.main([])
    assert e.value.code not in (0, None)
    assert "--backend" in str(e.value.code)


def test_sleep_time_scale_deadlines_equal_jax(monkeypatch):
    """The deadline chain off the busy cursor, scaled, on a frozen clock."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    ours = SleepCompressor(gbps=0.5, time_scale=256.0)
    theirs = JaxSleep(gbps=0.5, time_scale=256.0)
    for nbytes, step in ((P, 0.0), (3 * P + 5, 0.001), (0, 0.5),
                         (4 << 20, 10.0)):
        clock[0] += step
        assert ours._deadline(nbytes) == theirs._deadline(nbytes)
    assert ours._busy_until == theirs._busy_until > clock[0]


def test_run_skip_e2e_has_no_file_rows(tmp_path):
    """The corpus table alone: one packet of each corpus through the
    kernels' plain versions on the CPU (untimed, so no rates)."""
    out = tmp_path / "run.json"
    rows = run.main(["--skip-e2e", "--mib", "0.001", "--out", str(out)],
                    device=CPU)
    assert [r["corpus"] for r in rows] == \
        ["random", "enwik-proxy", "text", "utf8-text", "zeros"]
    assert not any(r["corpus"].startswith("file-e2e") for r in rows)
    assert all(r["encode_gbps"] is None for r in rows)
    assert json.loads(out.read_text())["rows"] == rows


@pytest.mark.gpu
def test_gpu_scaling_decompress_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = scaling.main(["--backend", "gpu", "--mode", "d", "--worlds", "1,2",
                        "--per-host-mib", "16", "--tmpdir", str(tmp_path)])
    assert out["mode"] == "d" and set(out) == JAX_KEYS | {"card", "cards"}
    assert [w["world"] for w in out["worlds"]] == [1, 2]
