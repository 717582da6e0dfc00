"""The port's benchmark and its sources against the JAX package's.

* ``gpuar_tpu_torch.bench.corpora`` against ``benchmarks/enwik_proxy.py``
  (pinned sha256s, the same bytes at every size, prefix stability), the
  random corpus against ``bench.py``'s and ``benchmarks/run.py``'s, and
  the underflow adversary against ``tests/test_pallas_encode.py``'s;
* ``pipeline.generate_random_file`` against ``gpuar_tpu.pipeline``'s;
* the executable specification (``ops/golden.py``, ``models/adaptive.py``)
  against ``gpuar_tpu.ops.golden`` and the port's native golden codec on
  the fixture corpora;
* each cell's pinned archive sha256 (``ARCHIVE_SHA256``) against the
  JAX package's HostCompressor archive of the cell's full corpus (the
  1 GiB ``random_1g`` too);
* ``BENCHMARK.json``'s workloads against ``CELLS``: names, ``args``, and
  packets and super-batches as the bench cuts each cell's size; each
  cell's corpus of its kind in ``CORPUS``, and a cell without one refused;
* ``python -m gpuar_tpu_torch.bench``: its checks on the CPU (the plain
  versions), a mutated packet, a packet the executable specification
  does not make, a different archive and an archive off its pin failing
  them with a non-zero exit, the window's rates and its blocks'
  /proc/meminfo readings, the work directory's filesystem and the
  refusal of a short disk before any run, no device metric from a CPU
  run, and the command failing without a CUDA device;
* each run writes a new file: through bench_cell's CUDA path on the CPU
  (the card faked), no run writes to a path that exists, every
  decompress reads its own compress's archive, the unlinks fall outside
  every timed span, the check after the window holds the last run's
  archive, and ``--workdir`` moves the files;
* ``bench.bounds``: the larger of the within-window and the
  between-invocation spread, and the rule's minimum of calls and
  invocations.  The GPU-marked test runs a cell on the card.

Tolerance: 0 bytes throughout.
"""

import hashlib
import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import enwik_proxy
from gpuar_tpu.ops import golden as jax_golden_spec
from gpuar_tpu_torch import native as port_native
from gpuar_tpu_torch.bench import __main__ as bench
from gpuar_tpu_torch.bench import corpora, stages
from gpuar_tpu_torch.models.adaptive import AdaptiveModel
from gpuar_tpu_torch.ops import golden
from gpuar_tpu_torch.parallel.runner import GPUCompressor
from gpuar_tpu_torch.pipeline import HostCompressor
from test_torch_host import CORPUS_NAMES, corpora as fixture_corpora
from test_torch_host import jax_native
from test_torch_pipeline import one_torch_thread  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
P = 8192
# corpus kind (bench.CORPUS) -> its generator, uncached.
GENERATE = {"random": corpora.random_bytes, "enwik": corpora.generate}


@pytest.mark.parametrize("name", ["1M", "16M", "100M", "UTF8_1M"])
def test_pins_equal_the_originals(name):
    assert getattr(corpora, f"SHA256_{name}") == \
        getattr(enwik_proxy, f"SHA256_{name}")


@pytest.mark.parametrize("kind,pin", [("enwik", corpora.SHA256_1M),
                                      ("utf8", corpora.SHA256_UTF8_1M)])
def test_one_mib_is_pinned(kind, pin):
    gen = corpora.generate if kind == "enwik" else corpora.generate_utf8
    assert hashlib.sha256(gen(1 << 20)).hexdigest() == pin


@pytest.mark.parametrize("size", [0, 1, 100, 4097, 1 << 16, 1_000_003])
def test_generators_equal_the_originals(size):
    assert corpora.generate(size) == enwik_proxy.generate(size)
    assert corpora.generate_utf8(size) == enwik_proxy.generate_utf8(size)


def test_generators_are_prefix_stable():
    for gen in (corpora.generate, corpora.generate_utf8):
        assert gen(1 << 17)[: 1 << 16] == gen(1 << 16)


def test_cached_pinned_size_is_kept_and_checked(tmp_path):
    data = corpora.cached("enwik", 1 << 20, cache=tmp_path)
    assert corpora.sha256(data) == corpora.SHA256_1M
    path = tmp_path / f"enwik_{1 << 20}.bin"
    assert path.read_bytes() == data
    # A file that fails its sha256 is generated again.
    path.write_bytes(b"x" + data[1:])
    assert corpora.cached("enwik", 1 << 20, cache=tmp_path) == data
    assert path.read_bytes() == data
    # Any other size is generated fresh and not kept.
    assert corpora.cached("utf8", 12345, cache=tmp_path) == \
        enwik_proxy.generate_utf8(12345)
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]


def test_cached_refuses_a_corpus_that_misses_its_pin(tmp_path, monkeypatch):
    monkeypatch.setitem(corpora.PINNED, ("enwik", 1000), "0" * 64)
    with pytest.raises(RuntimeError, match="pinned sha256"):
        corpora.cached("enwik", 1000, cache=tmp_path)
    assert not list(tmp_path.iterdir())


def test_random_corpus_is_the_jax_harnesses():
    """bench.py draws [8192, 8192] at seed 0xBE7C, benchmarks/run.py a flat
    size; both are corpora.random_bytes."""
    n = 16
    want = np.random.default_rng(0xBE7C).integers(0, 256, (n, P), np.uint8)
    assert corpora.random_bytes(n * P) == want.tobytes()
    flat = np.random.default_rng(0xBE7C).integers(0, 256, 5 * P + 3,
                                                  np.uint8)
    assert corpora.random_bytes(5 * P + 3) == flat.tobytes()


def test_adversary_is_the_jax_tests():
    from tests.test_pallas_encode import _adversarial_underflow_packet

    np.testing.assert_array_equal(corpora.adversarial_underflow_packet(),
                                  _adversarial_underflow_packet())
    np.testing.assert_array_equal(corpora.adversarial_underflow_packet(300),
                                  _adversarial_underflow_packet(300))


@pytest.mark.parametrize("size", [0, 1, 3 * (1 << 20) + 5])
def test_generate_random_file_equals_jax(tmp_path, size):
    from gpuar_tpu.pipeline import generate_random_file as jax_gen
    from gpuar_tpu_torch.pipeline import generate_random_file

    generate_random_file(tmp_path / "port.bin", size, seed=0xBE7C)
    jax_gen(tmp_path / "jax.bin", size, seed=0xBE7C)
    got = (tmp_path / "port.bin").read_bytes()
    assert got == (tmp_path / "jax.bin").read_bytes()
    assert got == corpora.random_bytes(size)


@pytest.mark.parametrize("case", CORPUS_NAMES)
def test_golden_spec_equals_jax_and_native(case):
    """Each 8192-byte chunk of a fixture corpus: the port's executable
    specification encodes to the JAX module's packet and the port's
    native golden codec's, and decodes every one of them back."""
    blob = fixture_corpora()[case]
    for o in range(0, max(len(blob), 1), P):
        chunk = blob[o: o + P]
        pkt = golden.encode_packet(chunk)
        assert pkt == jax_golden_spec.encode_packet(chunk)
        assert pkt == port_native.encode_packet(chunk)
        assert golden.decode_packet(pkt) == chunk


def test_adaptive_model_equals_jax():
    from gpuar_tpu.models.adaptive import AdaptiveModel as JaxModel

    rng = np.random.default_rng(0xADA)
    ours, theirs = AdaptiveModel(), JaxModel()
    for s in rng.integers(0, 256, 3000):
        s = int(s)
        assert ours.low_high(s) == theirs.low_high(s)
        assert ours.cumprob == theirs.cumprob
        u = int(rng.integers(0, ours.cumprob))
        assert ours.find_symbol(u) == theirs.find_symbol(u)
        ours.update(s)
        theirs.update(s)
    np.testing.assert_array_equal(ours.cumfreq, theirs.cumfreq)


@pytest.mark.parametrize("cell", sorted(bench.CELLS))
def test_archive_pins_equal_the_jax_host_archive(tmp_path, cell):
    """The bench holds each full-size cell's GPU archive to a sha256 that
    the JAX package's host codec makes from the same corpus."""
    jax_native()
    from gpuar_tpu.pipeline import HostCompressor as JaxHost

    size = bench.CELLS[cell]
    data = GENERATE[bench.CORPUS[cell]](size)
    if cell == "enwik8_proxy_100m":
        assert corpora.sha256(data) == corpora.SHA256_100M
    src, gip = tmp_path / "in.bin", tmp_path / "jax.gip"
    src.write_bytes(data)
    del data
    JaxHost(threads=4).compress(src, gip)
    assert bench.md5(gip, "sha256") == bench.ARCHIVE_SHA256[cell]


def _workloads() -> dict:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return {w["name"]: w for w in spec["workloads"]}


def test_benchmark_json_names_the_cells():
    assert sorted(_workloads()) == sorted(bench.CELLS)
    assert sorted(bench.CORPUS) == sorted(bench.CELLS)
    assert set(bench.CORPUS.values()) <= set(GENERATE)


@pytest.mark.parametrize("cell", sorted(bench.CELLS))
def test_benchmark_json_cell_is_the_bench_cut(cell):
    """Each workload runs its own cell; its packets are those the bench
    cuts the cell's full size into, and its super-batches those the drive
    loops cut them into at the configuration's super-batch, the one
    GPUCompressor sizes from the H100 (132 SMs, 2 blocks of 64 threads an
    SM)."""
    from gpuar_tpu_torch.parallel.runner import batch_packets

    w = _workloads()[cell]
    assert w["args"] == ["--cell", cell]
    assert w["configuration"] == "gpuar-8k-packets" and w["chips"] == 1
    settings = json.loads((REPO / "BENCHMARK.json").read_text())[
        "configurations"][0]["settings"]
    n = settings["super_batch_packets"]
    assert n == batch_packets((132, 2, 64))
    assert settings["super_batch_bytes"] == n * P
    cut = bench.batch_packets(bench.CELLS[cell], P)
    assert w["packets"] == sum(cut)
    assert w["super_batches"] == len(bench.batch_packets(bench.CELLS[cell],
                                                         n))


# A super-batch of packets -> the cuts of random_1g and of 1e8 B at it:
# the JAX package's 8192 (the bench's cut before the kernel layer took
# the loops' launch, and the CPU devices' still) and the H100's 4224.
CUTS = {8192: ([8192] * 16, [8192, 4016]),
        4224: ([4224] * 31 + [128], [4224, 4224, 3760])}


@pytest.mark.parametrize("packets", sorted(CUTS))
def test_random_1g_is_sixteen_full_batches(packets):
    gib, enwik = CUTS[packets]
    assert bench.batch_packets(bench.CELLS["random_1g"], packets) == gib
    assert bench.batch_packets(100_000_000, packets) == enwik
    assert bench.batch_packets(0, packets) == []
    with pytest.raises(TypeError):   # no default cut: a caller names it
        bench.batch_packets(bench.CELLS["random_1g"])


@pytest.mark.parametrize("packets", [3, 4])
@pytest.mark.parametrize("size", [1, P - 1, 4 * P, 4 * P + 1, 9 * P + 77])
def test_batch_packets_is_how_batches_cut(size, packets):
    """batches' rows and sizes follow batch_packets, here with super-batches
    of 3 and 4 packets."""
    data = corpora.random_bytes(size)
    got = bench.batches(data, packets)
    assert [rows.shape[0] for rows, _, _ in got] == \
        bench.batch_packets(size, packets)
    assert b"".join(c.tobytes() for _, _, c in got) == data
    assert sum(int(s.sum()) for _, s, _ in got) == size


@pytest.mark.parametrize("cell", sorted(bench.CELLS))
def test_corpus_is_the_cells_kind(tmp_path, monkeypatch, cell):
    monkeypatch.setattr(corpora, "CACHE", tmp_path)
    want = GENERATE[bench.CORPUS[cell]](1 << 20)
    assert bench.corpus(cell, 1 << 20) == want
    if cell == "random_1g":
        assert want == corpora.random_bytes(1 << 20)


def test_corpus_refuses_a_cell_without_a_kind(monkeypatch):
    with pytest.raises(KeyError, match="no corpus kind"):
        bench.corpus("enwik9", 1 << 10)
    monkeypatch.setitem(bench.CELLS, "random_2g", 2 << 30)
    with pytest.raises(KeyError, match="random_2g"):
        bench.corpus("random_2g", 1 << 10)


def test_order0_bits():
    assert corpora.order0_bits(b"") == 0.0
    assert corpora.order0_bits(b"aaaa") == 0.0
    assert corpora.order0_bits(bytes(range(256)) * 3) == 8.0
    assert corpora.order0_bits(b"ab" * 10) == 1.0


def test_sample_keeps_the_ends_and_is_seeded():
    np.testing.assert_array_equal(bench.sample(5, 8, seed=0), np.arange(5))
    got = bench.sample(4016, 256, seed=1)
    assert got.size == 256 and np.unique(got).size == 256
    assert got[0] == 0 and got[-1] == 4015 and np.all(np.diff(got) > 0)
    np.testing.assert_array_equal(got, bench.sample(4016, 256, seed=1))
    assert not np.array_equal(got, bench.sample(4016, 256, seed=0))


def test_window_is_all_bytes_over_all_seconds():
    """Runs of 1e9 B: 1, 1, 2 and 4 s give 4 runs / 8 s = 0.5 GB/s, not the
    median run's 0.75; blocks of (1, 1), (2), (4) s."""
    w = bench.window(10 ** 9, [1.0, 1.0, 2.0, 4.0], blocks=3)
    assert w["gbps"] == 0.5
    assert w["blocks"] == [1.0, 0.5, 0.25]
    assert w["spread"] == (0.75 - 0.375) / 0.5
    assert w["runs"] == [0.4375, 0.75, 1.0]
    # Fewer runs than blocks: a block a run.
    assert bench.window(10 ** 9, [2.0], blocks=5)["blocks"] == [0.5]
    assert "dirty_kb" not in w


MEMINFO = """MemTotal:       98765432 kB
MemFree:        12345678 kB
Dirty:              {dirty} kB
Writeback:          {wb} kB
WritebackTmp:          7 kB
"""


def test_meminfo_reads_dirty_and_writeback():
    assert bench.meminfo(MEMINFO.format(dirty=1024, wb=0)) == \
        {"Dirty": 1024, "Writeback": 0}
    # The file's own fields, as the bench reads it after each run.
    assert set(bench.meminfo()) == set(bench.MEMINFO)


def test_window_blocks_carry_their_meminfo():
    """Five runs in 3 blocks, (1, 2), (3, 4), (5): each block's rate and
    its mean Dirty and Writeback readings."""
    mem = [bench.meminfo(MEMINFO.format(dirty=d, wb=w))
           for d, w in ((100, 0), (300, 10), (5000, 2000), (7000, 0),
                        (64, 8))]
    w = bench.window(10 ** 9, [1.0, 1.0, 2.0, 2.0, 4.0], blocks=3, mem=mem)
    assert w["blocks"] == [1.0, 0.5, 0.25]
    assert w["dirty_kb"] == [200.0, 6000.0, 64.0]
    assert w["writeback_kb"] == [5.0, 1000.0, 8.0]


MOUNTS = """overlay / overlay rw,relatime 0 0
proc /proc proc rw,nosuid 0 0
/dev/nvme0n1p1 /data ext4 rw,relatime 0 0
tmpfs /data/scratch tmpfs rw 0 0
/dev/vdb /data/scratch xfs rw 0 0
/dev/vdc /mnt/my\\040disk btrfs rw 0 0
"""


@pytest.mark.parametrize("path,kind", [
    ("/", "overlay"), ("/home/user/work", "overlay"), ("/data", "ext4"),
    ("/data/x/y", "ext4"), ("/data/scratchpad", "ext4"),
    ("/data/scratch/w", "xfs"), ("/mnt/my disk/w", "btrfs"),
    ("/proc/meminfo", "proc")])
def test_fs_type_is_the_longest_mount(path, kind):
    assert bench.fs_type(path, MOUNTS) == kind


def test_disk_room_refuses_a_short_disk(tmp_path, monkeypatch):
    room = bench.disk_room(tmp_path, 1)
    assert room["work_free_bytes"] > 1 and room["work_fs"] != "unknown"
    usage = shutil.disk_usage(tmp_path)
    monkeypatch.setattr(bench.shutil, "disk_usage",
                        lambda p: usage._replace(free=(6 << 30) - 1))
    with pytest.raises(SystemExit, match=f"needs {6 << 30} B"):
        bench.disk_room(tmp_path, 6 << 30)


def test_bench_command_refuses_a_short_disk_before_any_run(
        tmp_path, monkeypatch, capsys):
    """With a card but under 6 GiB free, random_1g exits non-zero naming
    the need before the corpus, a build or a run, and prints nothing."""
    usage = shutil.disk_usage(tmp_path)
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "OUT", tmp_path / "_bench")
    monkeypatch.setattr(bench.shutil, "disk_usage",
                        lambda p: usage._replace(free=5 << 30))
    monkeypatch.setattr(bench, "corpus", lambda *a: pytest.fail("ran"))
    with pytest.raises(SystemExit) as e:
        bench.main(["--cell", "random_1g"])
    assert e.value.code not in (0, None)
    assert f"needs {bench.DISK_FILES << 30} B" in str(e.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("packets", sorted(CUTS))
def test_batches_cut_the_enwik8_cell_as_the_pipeline(packets):
    """100,000,000 B: 12,208 packets in super-batches of 8192 and 4016, or
    of 4224, 4224 and 3760, the last packet 256 B."""
    got = bench.batches(bytes(100_000_000), packets)
    assert [rows.shape for rows, _, _ in got] == \
        [(n, P) for n in CUTS[packets][1]]
    assert int(got[-1][1][-1]) == 256
    assert sum(int(s.sum()) for _, s, _ in got) == 100_000_000


def _small_corpus() -> bytes:
    """One 3000-byte packet of the enwik proxy: the plain versions on the
    CPU take a step a symbol, seconds for a full packet."""
    return corpora.generate(3000)


def test_bench_cell_checks_pass_on_the_cpu(tmp_path):
    r = bench.bench_cell("enwik8_proxy_100m", _small_corpus(), tmp_path,
                         GPUCompressor(devices=[CPU]), HostCompressor(), CPU,
                         runs=1, seconds=0, host_runs=1)
    assert r["correct"] is True
    assert (r["packets"], r["super_batches"], r["bytes"]) == (1, 1, 3000)
    assert r["checks"] == {"golden_sampled": 1, "archive_pinned": False}
    assert r["runs"] == 1
    # A CPU run reports no device metric.
    assert not set(r) & set(bench.LAYERS)
    assert "setup" not in r and "detail" not in r


def test_bench_fails_on_a_mutated_packet(tmp_path, monkeypatch):
    from gpuar_tpu_torch.ops import encode

    real = encode.encode_batch

    def mutated(d, s):
        pk, ln = real(d, s)
        pk = pk.clone()
        pk[0, 5] ^= 1   # a bitstream byte
        return pk, ln

    monkeypatch.setattr(encode, "encode_batch", mutated)
    with pytest.raises(SystemExit) as e:
        bench.bench_cell("enwik8_proxy_100m", _small_corpus(), tmp_path,
                         GPUCompressor(devices=[CPU]), HostCompressor(), CPU,
                         runs=1, seconds=0, host_runs=1)
    assert e.value.code not in (0, None)
    assert "packet 0: K1 differs from the golden codec" in str(e.value.code)


def test_bench_fails_where_the_specification_disagrees(monkeypatch):
    """K1 and the native golden codec agree, but the executable
    specification makes another packet (as when both engines moved
    alike): the bench fails."""
    real = golden.encode_packet
    monkeypatch.setattr(golden, "encode_packet",
                        lambda chunk: real(chunk[:-1] + b"\x00"))
    data = corpora.generate(2 * P + 100)
    with pytest.raises(SystemExit) as e:
        bench.kernel_layer(data, CPU, HostCompressor(), P)
    assert "executable specification" in str(e.value.code)


def test_bench_fails_on_an_archive_unlike_the_hosts(tmp_path):
    for name, data in (("in.bin", b"abc"), ("back.bin", b"abc"),
                       ("g.gip", b"one"), ("h.gip", b"two")):
        (tmp_path / name).write_bytes(data)
    with pytest.raises(SystemExit) as e:
        bench.check_archive(tmp_path / "in.bin", tmp_path / "g.gip",
                            tmp_path / "back.bin", tmp_path / "h.gip",
                            bench.md5(tmp_path / "in.bin"))
    assert "differs from HostCompressor's" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        bench.check_archive(tmp_path / "in.bin", tmp_path / "g.gip",
                            tmp_path / "back.bin", tmp_path / "g.gip",
                            "0" * 32)
    assert "md5" in str(e.value.code)
    # Equal to the host's but off its pin.
    with pytest.raises(SystemExit) as e:
        bench.check_archive(tmp_path / "in.bin", tmp_path / "g.gip",
                            tmp_path / "back.bin", tmp_path / "g.gip",
                            bench.md5(tmp_path / "in.bin"), "0" * 64)
    assert "differs from its pin" in str(e.value.code)
    bench.check_archive(tmp_path / "in.bin", tmp_path / "g.gip",
                        tmp_path / "back.bin", tmp_path / "g.gip",
                        bench.md5(tmp_path / "in.bin"),
                        bench.md5(tmp_path / "g.gip", "sha256"))


# --- each run writes a new file (bench.Outputs)


def _recording(base: type, name: str, calls: list, work: Path,
               mutate=None) -> type:
    """A subclass of ``base`` whose compress and decompress note, in
    ``calls``, (name, verb, src, dst, whether dst existed, start, end,
    the files in ``work`` at the end); ``mutate(verb, k, src, dst)``, if
    given, runs after the k-th call of the verb."""
    def wrap(verb):
        def call(self, src, dst, *args, **kw):
            existed = Path(dst).exists()
            t0 = time.perf_counter()
            out = getattr(base, verb)(self, src, dst, *args, **kw)
            t1 = time.perf_counter()
            k = sum(c[:2] == (name, verb) for c in calls)
            calls.append((name, verb, Path(src), Path(dst), existed, t0, t1,
                          len(list(work.iterdir()))))
            if mutate is not None:
                mutate(verb, k, Path(src), Path(dst))
            return out
        return call
    return type(f"Recording{base.__name__}", (base,),
                {verb: wrap(verb) for verb in bench.VERBS})


def _fake_card(monkeypatch, spans: list) -> types.SimpleNamespace:
    """bench_cell's CUDA path on the CPU: a device that reads "cuda", the
    kernel layer's times and the trace faked, the stage runs real on the
    CPU (their lead-in, which needs the card, read as 0).  Every span
    ``_timed`` measures and every unlink call goes into ``spans`` as
    (kind, start, end)."""
    real_timed, real_drop = bench._timed, bench.Outputs.drop
    real_stage_run = stages.stage_run

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = real_timed(fn, *args)
        spans.append(("timed", t0, time.perf_counter()))
        return out

    def drop(self, *paths):
        t0 = time.perf_counter()
        real_drop(self, *paths)
        spans.append(("unlink", t0, time.perf_counter()))

    def stage_run(*args):
        return {**real_stage_run(*args), "lead_in_s": 0.0}

    def kernel_layer(data, device, host, packets, golden_sample):
        return [{"packets": 1, "bytes": len(data), "comp_bytes": 1,
                 "golden_sampled": 1, "k1_ms": 1.0, "k2_ms": 1.0,
                 "k1_reps": [1.0], "k2_reps": [1.0]}]

    monkeypatch.setattr(bench, "_timed", timed)
    monkeypatch.setattr(bench.Outputs, "drop", drop)
    monkeypatch.setattr(stages, "stage_run", stage_run)
    monkeypatch.setattr(bench, "kernel_layer", kernel_layer)
    monkeypatch.setattr(bench, "traced", lambda fn, *args: (
        fn(*args), ((1.0, 0.5, {}), {}))[1])
    return types.SimpleNamespace(type="cuda")


def _fake_card_cell(tmp_path, monkeypatch, mutate=None, runs=3):
    """One cell through the faked card on 300 B of the enwik proxy, the
    compressors recorded -> (the result or the Failure, calls, spans)."""
    calls, spans = [], []
    device = _fake_card(monkeypatch, spans)
    gpu = _recording(GPUCompressor, "gpu", calls, tmp_path, mutate)(
        devices=[CPU])
    host = _recording(HostCompressor, "host", calls, tmp_path)()
    try:
        r = bench.bench_cell("enwik8_proxy_100m", corpora.generate(300),
                             tmp_path, gpu, host, device, runs=runs,
                             seconds=0, host_runs=2)
    except SystemExit as e:
        r = e
    return r, calls, spans


def test_every_run_writes_a_new_file(tmp_path, monkeypatch,
                                     one_torch_thread):
    """Through the CUDA path of bench_cell (the card faked): the cold
    run, the host baseline, both stage runs, every run of the window and
    the traced runs each write to a path that does not exist when the
    run starts, and no path twice; every decompress reads the archive
    its own compress just wrote; the unlinks fall outside every timed
    span and every run, and are reported under setup and detail; the
    work directory never holds more than DISK_FILES - 1 files."""
    r, calls, spans = _fake_card_cell(tmp_path, monkeypatch, runs=3)
    assert r["correct"] is True and r["runs"] == 3
    gpu = [c for c in calls if c[0] == "gpu"]
    host = [c for c in calls if c[0] == "host"]
    # cold, stage before, 3 window runs, stage after, traced.
    assert [c[1] for c in gpu] == ["compress", "decompress"] * 7
    assert [c[1] for c in host] == ["compress", "decompress"] * 2
    assert not any(c[4] for c in calls)
    dsts = [c[3] for c in calls]
    assert len(set(dsts)) == len(dsts)
    assert all(c[2] == tmp_path / "in.bin" for c in calls
               if c[1] == "compress")
    for runs in (gpu, host):
        for c, d in zip(runs[::2], runs[1::2]):
            assert d[2] == c[3] and d[3].suffix == ".bin"
    # The unlinks: between runs, outside every timed span.
    unlinks = [(a, b) for kind, a, b in spans if kind == "unlink"]
    busy = [(a, b) for kind, a, b in spans if kind == "timed"] + \
        [(c[5], c[6]) for c in calls]
    assert unlinks
    assert all(b <= a2 or b2 <= a for a, b in unlinks for a2, b2 in busy)
    # The cold pair with the host's round trip, one host pair, two stage
    # pairs, two window pairs and the traced pair.
    assert r["setup"]["unlinks"] == len(unlinks) == 7
    assert len(r["detail"]["unlink_s"]) == 7
    assert r["setup"]["unlink_s"] == pytest.approx(
        sum(r["detail"]["unlink_s"]))
    assert max(c[7] for c in calls) <= bench.DISK_FILES - 1
    # What stays: the source, the host archive and the last window pair.
    last = gpu[9]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["in.bin", host[-2][3].name, last[3].name, last[2].name])
    assert r["window_s"] == [pytest.approx(sum(r["detail"]["compress_s"])),
                             pytest.approx(sum(r["detail"]["decompress_s"]))]


def test_outputs_pair_refuses_a_path_that_exists(tmp_path):
    out = bench.Outputs(tmp_path)
    assert out.pair() == (tmp_path / "gpu_0.gip", tmp_path / "gpu_back_0.bin")
    (tmp_path / "host_back_1.bin").write_bytes(b"x")
    with pytest.raises(SystemExit, match="host_back_1.bin exists"):
        out.pair("host")
    out.drop(tmp_path / "host_back_1.bin")
    assert out.unlink_s and not any(tmp_path.iterdir())


def test_post_window_check_holds_the_last_runs_archive(
        tmp_path, monkeypatch, one_torch_thread):
    """The check after the window fails when the last window run's
    archive (the fourth decompress's: after the cold and the stage run,
    the second of two window runs) is unlike the host's, though the
    traced and stage runs' archives are right; it names that archive."""
    def mutate(verb, k, src, dst):
        if verb == "decompress" and k == 3:
            with open(src, "r+b") as f:
                f.seek(-1, 2)
                last = f.read(1)
                f.seek(-1, 2)
                f.write(bytes([last[0] ^ 1]))

    r, calls, _ = _fake_card_cell(tmp_path, monkeypatch, mutate, runs=2)
    assert isinstance(r, SystemExit) and r.code not in (0, None)
    gpu = [c for c in calls if c[0] == "gpu"]
    assert len(gpu) == 12   # every run made: the check comes after them
    assert f"{gpu[7][2].name}: the GPU archive differs from " \
        "HostCompressor's" in str(r.code)


def test_bench_command_puts_files_under_workdir(tmp_path, monkeypatch):
    """--workdir DIR: the disk guard reads DIR's filesystem and the cell's
    temporary directory is made in it; without it, under OUT."""
    from gpuar_tpu_torch.parallel import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "OUT", tmp_path / "out")
    monkeypatch.setattr(bench, "setup_card", lambda: (
        "card", CPU, dict.fromkeys(("cuda_init_s", "build_load_s",
                                    "host_build_load_s"), 0.0)))
    monkeypatch.setattr(runner, "GPUCompressor", lambda: None)
    monkeypatch.setattr(bench, "report", lambda card, r: None)
    monkeypatch.setattr(bench, "refuse_foreign", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    guarded, works = [], []
    real_room = bench.disk_room
    monkeypatch.setattr(bench, "disk_room", lambda path, need: (
        guarded.append(path), real_room(path, need))[1])

    def cell(cell, data, work, *args, **kw):
        works.append(work)
        return {"setup": {}}

    monkeypatch.setattr(bench, "bench_cell", cell)
    for argv, where in ((["--workdir", str(tmp_path / "shm")],
                         tmp_path / "shm"), ([], tmp_path / "out")):
        guarded.clear()
        assert bench.main(["--cell", "random_64m", "--mib", "0", *argv]) == 0
        assert guarded == [where, where]
        assert works[-1].parent == where and not works[-1].exists()


# --- the bounds from invocations (bench/bounds.py)


def _invocation(cell, c, d, cs=0.01, ds=0.02):
    return {"cell": cell, "compress_gbps": c, "decompress_gbps": d,
            "compress_gbps_spread": cs, "decompress_gbps_spread": ds}


def _write_call(directory: Path, results: list[list[dict]]) -> Path:
    """One call's logs: a file an invocation, its lines as the bench's
    (text lines, then each cell's JSON line)."""
    directory.mkdir()
    for k, cells in enumerate(results):
        lines = ["[card] a text line", "{not json"]
        for r in cells:
            lines += [f"[card] {r['cell']} end to end: ...", json.dumps(r)]
        (directory / f"c{k}.log").write_text("\n".join(lines) + "\n")
    return directory


def test_bounds_take_the_larger_of_within_and_between(tmp_path):
    from gpuar_tpu_torch.bench import bounds

    a = _write_call(tmp_path / "a", [
        [_invocation("x", 1.0, 2.0), _invocation("y", 3.0, 3.0)],
        [_invocation("x", 1.2, 2.0, cs=0.3), _invocation("y", 3.0, 3.0)],
        [_invocation("x", 1.1, 2.0), _invocation("y", 3.0, 3.0)]])
    b = _write_call(tmp_path / "b", [
        [_invocation("x", 1.0, 1.5)], [_invocation("x", 1.0, 2.0)],
        [_invocation("x", 1.0, 2.0)], [_invocation("x", 1.0, 2.1)]]
        + [[_invocation("y", 3.0, 3.01)]] * 3)
    table = bounds.bounds([bounds.read_call(a), bounds.read_call(b)])
    x = table["x"]
    assert x["compress_gbps"]["rates"] == [[1.0, 1.2, 1.1], [1.0] * 4]
    assert x["compress_gbps"]["between"] == pytest.approx([0.2 / 1.1, 0.0])
    # The window's spread is the larger here, the invocations' below.
    assert x["compress_gbps"]["spread_seen"] == 0.3
    assert x["compress_gbps"]["bound"] == pytest.approx(0.45)
    assert x["decompress_gbps"]["between"] == pytest.approx([0.0, 0.6 / 2])
    assert x["decompress_gbps"]["spread_seen"] == pytest.approx(0.3)
    # A spread under a third of MIN_BOUND still gets MIN_BOUND.
    y = table["y"]["decompress_gbps"]
    assert y["spread_seen"] == 0.02 and y["bound"] == bounds.MIN_BOUND
    spec = {"workloads": [{"name": n, "args": ["--cell", n], "metrics": {
        m: {"unit": "GB/s", "bound": 9.0, "spread_seen": 6.0}
        for m in bounds.METRICS}} for n in ("x", "y", "z")]}
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    assert bounds.main([str(a), str(b), "--write", str(path)]) == 0
    got = {w["name"]: w for w in json.loads(path.read_text())["workloads"]}
    assert got["x"]["metrics"]["compress_gbps"] == {
        "unit": "GB/s", "bound": 0.45, "spread_seen": 0.3}
    assert got["y"]["metrics"]["decompress_gbps"]["bound"] == 0.05
    assert got["z"] == spec["workloads"][2]
    assert got["x"]["args"] == ["--cell", "x"]


@pytest.mark.parametrize("shape, why", [
    ([[3, 3]], "1 calls"), ([[3], [2]], "invocations in the calls")])
def test_bounds_refuse_too_few_invocations(tmp_path, shape, why):
    """The rule needs two calls, each with three invocations of every
    cell."""
    from gpuar_tpu_torch.bench import bounds

    calls = []
    for k, call in enumerate(shape):
        per = [[_invocation("x", 1.0, 1.0)] for _ in range(call[0])]
        calls.append(bounds.read_call(_write_call(tmp_path / str(k), per)))
    with pytest.raises(SystemExit, match=why):
        bounds.bounds(calls)


def test_bounds_read_the_benchmarks_own_json_lines(tmp_path):
    """A log as the bench prints it: its cell's JSON line is the one read
    (report's text lines skipped)."""
    from gpuar_tpu_torch.bench import bounds

    r = _invocation("random_64m", 1.5, 1.25)
    text = "[card] random_64m: 67108864 B ...\n" + json.dumps(r) + "\n"
    assert bounds.cell_lines(text) == [r]
    assert bounds.cell_lines('{"ok": true}\n') == []


def test_bench_command_without_cuda_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run([sys.executable, "-m", "gpuar_tpu_torch.bench",
                        "--cell", "random_64m"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert r.stdout == ""


# --- the stage clock (bench/stages.py) and the kernel layer's cut


@pytest.mark.parametrize("cell,total,cut", [
    ("random_64m", 256, 2), ("enwik8_proxy_100m", 512, 3),
    ("random_1g", 4096, 32)])
@pytest.mark.parametrize("packets", sorted(CUTS))
def test_golden_sample_per_cell_at_full_size(cell, total, cut, packets):
    """At the loops' launch (4224 on the H100) each cell holds as many
    packets to the executable specification as it did at 8192 (256 a 64
    MiB), spread over its batches, none past a batch's packets."""
    counts = bench.batch_packets(bench.CELLS[cell], packets)
    quota = bench.golden_quota(counts, bench.golden_total(bench.CELLS[cell]))
    assert sum(quota) == total
    assert all(0 < q <= n for q, n in zip(quota, counts))
    assert max(quota) - min(quota) <= 1
    if packets == 4224:
        assert len(counts) == cut


def test_golden_quota_spreads_and_caps():
    assert bench.golden_quota([1, 5, 5], 7) == [1, 3, 3]
    assert bench.golden_quota([10, 10, 10], 7) == [3, 2, 2]
    assert bench.golden_quota([2, 3], 99) == [2, 3]
    assert bench.golden_quota([], 5) == []
    assert bench.golden_total(0) == 0
    assert bench.golden_total(1) == bench.GOLDEN_SAMPLE
    assert bench.golden_total(bench.GOLDEN_BYTES + 1, 8) == 16


class FakeGPU:
    """A GPUCompressor's launch fields."""

    def __init__(self, packets, from_card, devices):
        self.super_batch_packets = packets
        self.batch_from_card = from_card
        self.codec = type("Mesh", (), {"codecs": [None] * devices})()


@pytest.mark.parametrize("gpu,want", [
    (FakeGPU(4224, True, 1), 4224), (FakeGPU(16896, True, 4), 4224),
    (FakeGPU(8192, False, 1), 8192), (FakeGPU(3, False, 2), 8192)])
def test_launch_packets_is_one_cards_batch(gpu, want):
    assert bench.launch_packets(gpu) == want


def test_launch_packets_of_cpu_devices_keeps_8192():
    assert bench.launch_packets(GPUCompressor(devices=[CPU])) == 8192
    assert bench.launch_packets(GPUCompressor(devices=[CPU, CPU])) == 8192


def test_kernel_layer_cuts_at_the_launch(monkeypatch):
    """The kernel layer runs K1 and K2 on batches of ``packets``, each
    checked, and samples the specification by golden_quota: 2P + 100 B
    at 2 packets a batch is batches of 2 and 1 packets, 3 sampled."""
    seen = []
    real = bench.check_golden
    monkeypatch.setattr(bench, "check_golden",
                        lambda picked: (seen.extend(picked), real(picked)))
    rows = bench.kernel_layer(corpora.generate(2 * P + 100), CPU,
                              HostCompressor(), packets=2)
    assert [r["packets"] for r in rows] == [2, 1]
    assert [r["golden_sampled"] for r in rows] == [2, 1]
    assert [(b, i) for b, i, _, _ in seen] == [(0, 0), (0, 1), (1, 0)]


def _iv(*pairs):
    return [(a, b) for a, b in pairs]


def test_gap_covered_by_one_stage():
    """The card idles 2-5 s of a 10 s run while the loop fetches and the
    reader reads; the writer is in no stage."""
    r = stages.attribute(0.0, 10.0, _iv((0, 2), (5, 10)), {
        "main": [("fetch", 1.5, 5.5)], "reader": [("read", 0.0, 6.0)],
        "writer": []})
    assert r["idle_gaps"] == [{"start_ms": 2000.0, "ms": 3000.0,
                               "main": "fetch", "reader": "read",
                               "writer": "none"}]
    assert r["idle_by_loop_stage"]["fetch"] == 3.0
    assert r["lead_in_s"] == 0.0


def test_gap_split_between_two_stages_takes_the_larger():
    """A 4 s gap: 1 s of the loop's submit, 3 s of its wait on the writer;
    the splice that starts inside the wait and ends after the gap holds
    its own second (the innermost span)."""
    r = stages.attribute(0.0, 10.0, _iv((0, 3), (7, 10)), {
        "main": [("submit", 2.0, 4.0), ("wait on writer", 4.0, 9.0),
                 ("splice", 6.0, 6.5)]})
    gap = r["idle_gaps"][0]
    assert (gap["start_ms"], gap["ms"], gap["main"]) == \
        (3000.0, 4000.0, "wait on writer")
    by = r["idle_by_loop_stage"]
    assert by["submit"] == 1.0 and by["wait on writer"] == 2.5
    assert by["splice"] == 0.5 and by["none"] == 0.0


def test_gap_with_no_span_reads_none():
    r = stages.attribute(0.0, 4.0, _iv((0, 1), (3, 4)), {
        "main": [("submit", 0.0, 1.0)], "reader": [], "writer": []})
    assert r["idle_gaps"][0] == {"start_ms": 1000.0, "ms": 2000.0,
                                 "main": "none", "reader": "none",
                                 "writer": "none"}
    assert r["idle_by_loop_stage"]["none"] == 2.0
    assert sum(r["idle_by_loop_stage"].values()) == r["idle_s"]


def test_gap_at_the_start_is_the_lead_in():
    """No device stage until 1.25 s: the first gap is the lead-in, the
    reader's read and walk; gaps are listed the longest first, at most
    GAPS of them."""
    device = _iv((1.25, 2.0), *((2.0 + k + 0.5, 3.0 + k) for k in range(6)))
    r = stages.attribute(0.0, 8.0, device, {
        "main": [("wait on reader", 0.0, 1.25)],
        "reader": [("read", 0.0, 0.5), ("walk", 0.5, 1.25)]})
    assert r["lead_in_s"] == 1.25
    first = r["idle_gaps"][0]
    assert (first["start_ms"], first["ms"]) == (0.0, 1250.0)
    assert (first["main"], first["reader"]) == ("wait on reader", "walk")
    assert len(r["idle_gaps"]) == stages.GAPS
    assert [g["ms"] for g in r["idle_gaps"]] == [1250.0] + [500.0] * 4


@pytest.mark.parametrize("device", [
    [], [(0.0, 10.0)], [(-1.0, 0.5), (0.25, 2.0), (9.0, 12.0)],
    [(1.0, 2.0), (1.5, 1.75), (3.0, 3.0), (4.0, 6.0), (5.0, 7.0)]])
def test_idle_and_device_seconds_are_the_wall(device):
    """Overlapping device stages count once, and a stage past the run's
    ends counts only inside it."""
    r = stages.attribute(0.0, 10.0, device, {"main": []})
    assert r["device_s"] + r["idle_s"] == pytest.approx(10.0, abs=1e-12)
    assert r["wall_s"] == 10.0
    assert sum(g["ms"] for g in r["idle_gaps"]) <= r["idle_s"] * 1e3 + 1e-9
    assert r["lead_in_s"] == (None if not device else
                              max(0.0, min(a for a, _ in device)))


def test_timeline_and_merge():
    assert stages.merge([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == \
        [(0, 2.5), (3, 4)]
    assert stages.gaps(0, 5, [(1, 2), (1.5, 3)]) == [(0, 1), (3, 5)]
    assert stages.timeline([("a", 0, 4), ("b", 1, 2)]) == \
        [(0, 1, "a"), (1, 2, "b"), (2, 4, "a")]


def test_stage_hooks_patch_attributes_that_exist():
    """Every attribute a stage hook patches is there, so a rename fails
    here rather than leaving a metric at 0; the lanes' threads carry the
    names the clock sorts spans by."""
    from gpuar_tpu_torch import pipeline

    for verb in bench.VERBS:
        got = stages.hooks(verb, GPUCompressor)
        for _, owner, attr, stage, stream, _ in got:
            assert callable(getattr(owner, attr)), (verb, owner, attr)
            assert stage in stages.STAGES[verb] or stage == "wait on <lane>"
            if stream is not None:
                assert stream in ("_stream", "_fetch_stream")
        assert {st for _, _, _, st, _, _ in got} >= {"submit", "fetch",
                                                     "buffer wait"}
    for owner, attr in ((GPUCompressor, "encode_submit"),
                        (GPUCompressor, "decode_submit_blob"),
                        (port_native, "walk_packets"),
                        (pipeline._PacketReader, "_carry_in"),
                        (port_native, "splice_at")):
        assert callable(getattr(owner, attr))
    threads = dict(stages.THREADS)
    for name in ("reader", "writer"):
        lane = pipeline._Lane(name)
        try:
            assert threads[lane._thread.name] == name
        finally:
            lane.close()
    assert not hasattr(pipeline, "open")   # the hook creates it for a run


def test_stage_run_on_the_cpu(tmp_path, one_torch_thread):
    """One stage-timed compress and decompress of 1 MiB on a CPU device
    (64-byte packets: four batches of 4096 each way): the reader's read
    and walk, the writer's write and the loop's opens and closes are
    timed, compress's loop splices nothing (``compress_splice_s`` reads
    0), the loop's stages sum to no more than the wall, no device stage
    is recorded, every hook is undone, and the round trip is exact."""
    from gpuar_tpu_torch import pipeline
    from gpuar_tpu_torch.parallel.codec import DeviceCodec

    data = corpora.generate(1 << 20)
    src, gip, back = tmp_path / "in.bin", tmp_path / "c.gip", \
        tmp_path / "back.bin"
    src.write_bytes(data)
    before = (DeviceCodec.encode_body_wait, DeviceCodec._download,
              pipeline._Lane.wait, GPUCompressor.encode_submit,
              port_native.walk_packets, pipeline._PacketReader._carry_in)
    runs = {}
    for verb, gpu, a, b in (
            ("compress", GPUCompressor(devices=[CPU], packet_size=64,
                                       super_batch_packets=32), src, gip),
            ("decompress", GPUCompressor(devices=[CPU], packet_size=64,
                                         super_batch_packets=4096), gip,
             back)):
        runs[verb] = r = stages.stage_run(gpu, verb, a, b)
        main = r["threads"]["main"]
        assert sum(sec for sec, _ in main.values()) <= r["wall_s"]
        assert main["submit"][1] == 4 and main["fetch"][1] == 4
        assert main["open"][1] == 2 and main["close"][1] >= 2
        assert r["threads"]["writer"]["write"][0] > 0
        assert r["threads"]["reader"]["read"][0] > 0
        assert r["device"] == {} and r["device_s"] == 0
        assert r["lead_in_s"] is None and r["idle_s"] == r["wall_s"]
        line = stages.line(r, stages.STAGES[verb])
        assert line.startswith("wall ") and "reader: read" in line
    assert runs["decompress"]["threads"]["reader"]["walk"][0] > 0
    # The dense reader's carry: one call a batch and the one that meets
    # the end, its bytes beside its seconds.
    dec = runs["decompress"]
    assert dec["threads"]["reader"]["carry"][1] == 5
    assert dec["bytes"]["carry"] >= 0 and runs["compress"]["bytes"] == {}
    assert f"carry {dec['threads']['reader']['carry'][0]:.6f} s x5 " \
        f"{dec['bytes']['carry']} B" in stages.line(
            dec, stages.STAGES["decompress"])
    # G1 gathers the body on the device: the loop splices nothing, and
    # compress_splice_s reads 0 (a stage a run lacks, stage_readings).
    assert "splice" not in runs["compress"]["threads"]["main"]
    assert back.read_bytes() == data
    assert before == (DeviceCodec.encode_body_wait, DeviceCodec._download,
                      pipeline._Lane.wait, GPUCompressor.encode_submit,
                      port_native.walk_packets,
                      pipeline._PacketReader._carry_in)
    assert not hasattr(pipeline, "open")


def _run(lead, device, reads, walk=0.0):
    return {"lead_in_s": lead, "device_s": device, "wall_s": 1.0,
            "device_share": device,
            "threads": {"main": {"splice": [0.25, 2]},
                        "reader": {"read": [reads, 3], "walk": [walk, 1]},
                        "writer": {"write": [0.5, 2]}},
            "idle_gaps": [{"start_ms": 0.0, "ms": 10.0, "main": "none",
                           "reader": "read", "writer": "none"}],
            "idle_by_loop_stage": {"none": 0.5}}


def test_stage_metrics_are_the_mean_of_the_two_runs():
    got = bench.stage_metrics({
        "compress": [_run(0.1, 0.2, 0.3), _run(0.3, 0.4, 0.5)],
        "decompress": [_run(0.5, 0.5, 0.5, 0.25), _run(0.5, 0.5, 0.5)]})
    assert set(got) == set(bench.STAGE_METRICS) <= set(bench.LAYERS)
    assert got["compress_lead_in_s"] == pytest.approx(0.2)
    assert got["compress_device_s"] == pytest.approx(0.3)
    assert got["compress_read_s"] == pytest.approx(0.4)
    assert got["compress_splice_s"] == 0.25
    assert got["decompress_walk_s"] == 0.125
    assert got["decompress_write_s"] == 0.5
    # The card's busy share is the stage runs' (device s over the wall).
    assert got["compress_device_busy_share"] == pytest.approx(0.3)


def test_stage_readings_keep_each_run_and_their_spread():
    runs = {"compress": [_run(0.1, 0.2, 0.3), _run(0.3, 0.4, 0.5)],
            "decompress": [_run(0.5, 0.5, 0.5, 0.25), _run(0.5, 0.5, 0.5)]}
    got = bench.stage_readings(runs)
    assert set(got) == set(bench.STAGE_METRICS)
    assert got["compress_lead_in_s"] == [0.1, 0.3]
    assert got["decompress_walk_s"] == [0.25, 0.0]
    assert bench.stage_metrics(runs) == {k: pytest.approx(np.mean(v))
                                         for k, v in got.items()}
    assert bench.spread([0.1, 0.3]) == pytest.approx(1.0)
    assert bench.spread([0.5, 0.5]) == 0.0 and bench.spread([0.0]) == 0.0


def test_breakdown_takes_the_longest_device_ops():
    trace = (1.0, 0.2, {f"op{k}": [float(k), k + 1] for k in range(9)})
    b = bench.breakdown(trace, {"encode": 0}, _run(0.1, 0.2, 0.3))
    assert [op["name"] for op in b["device_ops"]] == \
        [f"op{k}" for k in range(8, 2, -1)]
    assert b["device_ops"][0] == {"name": "op8", "ms": 8.0, "count": 9}
    assert b["trace_kernels"] == {}
    assert bench.kernel_records(b) == "no codec kernel launched"
    assert b["idle_by_loop_stage"] == {"none": 0.5}
    assert b["idle_gaps"][0]["reader"] == "read"


def test_trace_kernels_count_records_against_launches():
    """The trace's records of each codec kernel, by the names the
    profiler gives them (cut to 60 characters), against the launches the
    run made; a short trace says so."""
    from gpuar_tpu_torch.ops import _kernels

    per_name = {
        "void (anonymous namespace)::encode_kernel<16>(unsigned char": [
            3.0, 2],
        "void (anonymous namespace)::decode_kernel<false>(unsigned ch": [
            5.0, 28],
        "void (anonymous namespace)::decode_kernel<true>(unsigned cha": [
            1.0, 1],
        "Memcpy HtoD (Pinned -> Device)": [1.0, 4]}
    got = bench.trace_kernels(per_name, {"encode": 3, "decode": 28,
                                         "decode_debug": 0})
    assert got == {"encode": {"records": 2, "launches": 3},
                   "decode": {"records": 28, "launches": 28}}
    words = bench.kernel_records({"trace_kernels": got})
    assert words == ("encode 2 records of 3 launches: short, the busy "
                     "under-reads, decode 28 records of 28 launches")
    assert set(bench.TRACE_NAMES) == set(_kernels.LAUNCHES)


@pytest.mark.parametrize("names, want", [
    (["gpuar_tpu_torch", "gpuar_tpu_torch.bench", "jaxtyping", "flaxen",
      "numpy"], []),
    (["jax", "numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen", "gpuar_tpu.ops.golden"],
     ["flax.linen", "gpuar_tpu.ops.golden", "jaxlib.xla_client"])])
def test_foreign_modules_are_jax_and_the_jax_package(names, want):
    assert bench.foreign_modules(dict.fromkeys(names)) == want


@pytest.mark.parametrize("planted", ["jax", "jaxlib.xla_client", "flax",
                                     "gpuar_tpu.ops.golden"])
def test_bench_refuses_a_result_with_jax_loaded(monkeypatch, tmp_path,
                                                capsys, planted):
    """The command (card, cell and compressor faked) exits non-zero and
    prints no JSON line when a cell's run leaves JAX or the JAX package
    in the process."""
    import types

    from gpuar_tpu_torch.parallel import runner

    for name in bench.foreign_modules():
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "OUT", tmp_path)
    monkeypatch.setattr(bench, "setup_card", lambda: (
        "card", CPU, dict.fromkeys(("cuda_init_s", "build_load_s",
                                    "host_build_load_s"), 0.0)))
    monkeypatch.setattr(runner, "GPUCompressor", lambda: None)
    reported = []
    monkeypatch.setattr(bench, "report", lambda card, r: reported.append(r))

    def cell(*args, **kw):
        monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
        return {"setup": {}}

    monkeypatch.setattr(bench, "bench_cell", cell)
    with pytest.raises(SystemExit) as e:
        bench.main(["--cell", "random_64m", "--mib", "0"])
    assert e.value.code not in (0, None)
    assert planted in str(e.value.code)
    assert not reported and "{" not in capsys.readouterr().out


def test_benchmark_json_names_every_per_layer_metric():
    """BENCHMARK.json's per_layer lists every per-layer number the cell's
    JSON reports under LAYERS, and no other."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())["metrics"]
    ends = {"compress_gbps", "decompress_gbps"}
    assert set(spec["per_layer"]) == set(bench.LAYERS) - ends


@pytest.mark.gpu
def test_gpu_bench_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    r = bench.bench_cell("enwik8_proxy_100m", corpora.generate(3 << 20),
                         tmp_path, GPUCompressor(), HostCompressor(threads=0),
                         dev, runs=3, seconds=1.0, host_runs=1)
    assert r["correct"] is True
    for key in ("compress_gbps", "decompress_gbps", "k1_ms", "k2_ms",
                "kernel_gbps", "vs_baseline", "compress_process_s",
                "compress_io_s", "decompress_process_s", "decompress_io_s"):
        assert r[key] > 0, key
    assert len(r["detail"]["kernels"][0]["k1_reps"]) == bench.KERNEL_REPS
    # 384 packets: GOLDEN_SAMPLE of them through the specification's pool.
    assert r["checks"]["golden_sampled"] == bench.GOLDEN_SAMPLE
    assert r["runs"] >= 3 and min(r["window_s"]) >= 1.0
    # The kernel layer cuts one card's batch of the loops' super-batch.
    s = r["setup"]
    assert s["kernel_batch_packets"] * torch.cuda.device_count() == \
        s["loop_batch_packets"]
    for key in bench.STAGE_METRICS:
        # G1 gathers the body on the card: the loop splices nothing.
        if key == "compress_splice_s":
            assert r[key] == 0, key
        else:
            assert r[key] > 0, key
    assert r["breakdown"]["compress"]["trace_kernels"]["gather"][
        "launches"] == r["super_batches"]
    for verb in bench.VERBS:
        b = r["breakdown"][verb]
        assert set(b) == {"device_ops", "trace_kernels", "idle_gaps",
                          "idle_by_loop_stage"}
        assert b["device_ops"]
        kernel = "encode" if verb == "compress" else "decode"
        assert b["trace_kernels"][kernel]["launches"] == r["super_batches"]
        assert 0 < b["trace_kernels"][kernel]["records"] <= r["super_batches"]
        assert 0 < r[f"{verb}_device_busy_share"] < 1
        for run in r["detail"]["stages"][verb]:
            assert run["device_s"] + run["idle_s"] == \
                pytest.approx(run["wall_s"], rel=1e-6)
            assert 0 < run["lead_in_s"] < run["wall_s"]
    assert all(len(v) == 2 for v in r["detail"]["stage_metric_runs"].values())
