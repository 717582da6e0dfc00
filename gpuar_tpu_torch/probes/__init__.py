"""P1–P4: the TPU measurement probes of ``benchmarks/``, asked of the H100.

Each module holds a probe's kernel wrapper and, beside it, the plain
PyTorch version of the same function (a loop over steps of tensor ops on
the chains' lanes).  A CUDA tensor goes to the hand-written kernel
(``csrc/probe_model.cu``, ``csrc/profile_encode.cu``,
``csrc/probe_layouts.cu``); a CPU tensor goes to the plain version.
Nothing falls back: a CUDA input launches the kernel or raises.

  * ``probe_model``: P1, per-step cost of 21 model-update variants, and
    P2, the cost of loop-carried state;
  * ``profile_encode``: P3, the encoder cut off after each of its phases;
  * ``probe_layouts``: P4, the costs of the inner-loop primitives.

``python -m gpuar_tpu_torch.probes {model,carry,encode,layouts}`` runs them
at the probes' own sizes on the first GPU (``__main__``).

``LAUNCHES`` counts each wrapper's kernel launches (one per launch, nowhere
else), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import shutil
import subprocess

import torch

from gpuar_tpu_torch.ops import _kernels

LAUNCHES = {"probe_model": 0, "probe_carry": 0, "profile_encode": 0,
            "probe_layouts": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Launch C entry point ``entry`` on ``device``'s current stream (the
    stream is appended to ``args``), raise on a CUDA error, count it."""
    fn = _kernels.function(entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _kernels.check(fn(*args, stream), kernel)
    LAUNCHES[kernel] += 1


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for others."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def time_ms(fn, reps: int = 3) -> float:
    """The least of ``reps`` CUDA-event timings of one call of fn, after
    one call that is not timed (as the TPU probes took the least of 3).
    A device-side wait of about a millisecond runs before each start
    event, so the host has enqueued the call by the time the card reaches
    the event: the timing holds the kernel and not the wrapper's host
    time, which rivals the shortest probes."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)   # clock cycles
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    return "nvidia-smi unavailable"
