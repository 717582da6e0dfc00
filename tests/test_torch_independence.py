"""The port stands alone: nothing in ``gpuar_tpu_torch/`` or
``chip_smoke.py`` imports the JAX package or JAX.

An AST scan reads every import statement; a subprocess (this test process
has jax loaded by ``tests/conftest.py``) imports every module of the port
and ``chip_smoke.py`` and then finds neither in ``sys.modules``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "gpuar_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "gpuar_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


_IMPORT_ALL = """
import importlib, sys
sys.path.insert(0, {repo!r})
mods = {mods!r}
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert callable(chip_smoke.main)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "gpuar_tpu"))
print(len(mods), "modules", "leaked:", leaked)
sys.exit(1 if leaked else 0)
"""


def test_importing_the_port_loads_no_jax():
    pkg = REPO / "gpuar_tpu_torch"
    mods = []
    for p in sorted(pkg.rglob("*.py")):
        parts = p.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    assert "gpuar_tpu_torch.probes.__main__" in mods
    r = subprocess.run([sys.executable, "-c",
                        _IMPORT_ALL.format(repo=str(REPO), mods=mods)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "leaked: []" in r.stdout
