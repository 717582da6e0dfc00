"""The port package's own surface: the lazy library names.

``gpuar_tpu_torch.HostCompressor``, ``GPUCompressor``,
``DistributedCompressor`` and ``MeshCodec`` resolve to the modules'
classes when first named (the JAX package's lazy names, GPUCompressor
for its TPUCompressor); any other name raises AttributeError, and
importing the package starts no CUDA context.
"""

import subprocess
import sys
from pathlib import Path

import pytest

import gpuar_tpu_torch

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name,module", [
    ("HostCompressor", "gpuar_tpu_torch.pipeline"),
    ("GPUCompressor", "gpuar_tpu_torch.parallel.runner"),
    ("DistributedCompressor", "gpuar_tpu_torch.parallel.distributed"),
    ("MeshCodec", "gpuar_tpu_torch.parallel.mesh"),
])
def test_lazy_names_resolve_to_the_modules_classes(name, module):
    import importlib

    assert getattr(gpuar_tpu_torch, name) is \
        getattr(importlib.import_module(module), name)


@pytest.mark.parametrize("name", ["TPUCompressor", "nothing_here"])
def test_unknown_names_raise_attribute_error(name):
    with pytest.raises(AttributeError, match=name):
        getattr(gpuar_tpu_torch, name)
    assert not hasattr(gpuar_tpu_torch, name)


def test_import_starts_no_cuda_context():
    code = ("import torch, gpuar_tpu_torch, sys; "
            "gpuar_tpu_torch.GPUCompressor; gpuar_tpu_torch.MeshCodec; "
            "assert not torch.cuda.is_initialized(); "
            "assert 'jax' not in sys.modules; print('ok')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
