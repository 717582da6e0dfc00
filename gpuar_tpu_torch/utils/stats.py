"""Run statistics, split timers, and progress reporting (the port's copy of
``gpuar_tpu/utils/stats.py``).

Equivalent of the reference's CompressionInfo POD (src/compress_info.hpp),
StopWatch split timers (common/helper_timer.h, driven per I/O and compute
region), and decile ProgressMonitor (src/progress_monitor.cpp:17-33) — plus
throughput figures and a JSON dump the benchmark harness consumes.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time


@dataclasses.dataclass
class CompressionInfo:
    uncompressed_file_size: int = 0
    compressed_file_size: int = 0
    processed_uncompressed_size: int = 0
    process_time: float = 0.0  # seconds spent in codec compute
    io_time: float = 0.0       # seconds spent reading/writing files

    @property
    def ratio(self) -> float:
        if self.uncompressed_file_size == 0:
            return 0.0
        return self.compressed_file_size / self.uncompressed_file_size

    @property
    def score(self) -> float:
        """Composite score, higher is better (src/main.cpp:182)."""
        if self.ratio <= 0 or self.process_time <= 0:
            return 0.0
        return 1000.0 / (self.ratio ** 0.6 * self.process_time ** 0.4)

    @property
    def throughput_gbps(self) -> float:
        """Uncompressed GB/s through the codec (compute time only)."""
        if self.process_time <= 0:
            return 0.0
        return self.processed_uncompressed_size / self.process_time / 1e9

    def to_json(self) -> str:
        return json.dumps(
            {
                "uncompressed_bytes": self.uncompressed_file_size,
                "compressed_bytes": self.compressed_file_size,
                "ratio": self.ratio,
                "process_time_s": self.process_time,
                "io_time_s": self.io_time,
                "throughput_gbps": self.throughput_gbps,
                "score": self.score,
            }
        )


class SplitTimer:
    """Accumulating stopwatch; start/stop pairs sum into .total."""

    __slots__ = ("total", "_t0")

    def __init__(self) -> None:
        self.total = 0.0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class ProgressMonitor:
    """Prints NN%.. every decile of processed bytes (progress_monitor.cpp)."""

    def __init__(self, enabled: bool = True, stream=None) -> None:
        self.enabled = enabled
        self.stream = stream or sys.stdout
        self._last_decile = -1

    def reset(self) -> None:
        self._last_decile = -1

    def update(self, info: CompressionInfo) -> None:
        if not self.enabled or info.uncompressed_file_size <= 0:
            return
        decile = (
            info.processed_uncompressed_size * 10 // info.uncompressed_file_size
        )
        while self._last_decile < min(decile, 10):
            self._last_decile += 1
            self.stream.write(f"{self._last_decile * 10}%..")
            self.stream.flush()
        if decile >= 10 and self._last_decile >= 10:
            pass

    def finish(self) -> None:
        """Matches the reference's 100% line (progress_monitor.cpp:30)."""
        if self.enabled:
            self.stream.write("Closing file..\n")
            self.stream.flush()
