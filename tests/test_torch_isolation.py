"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no module of it (or the GPU smoke script) imports them."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
#: ``import jax``, ``from jax…``, ``import repro``, ``from repro.…`` —
#: but not ``repro_torch``
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|,|$)",
                       re.MULTILINE)


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.core.distributed, "
            "repro_torch.core.partition, repro_torch.core.faults, "
            "repro_torch.core.plan_stream, repro_torch.core.engine\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'repro') or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_port_sources_exist():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES
             if p.is_relative_to(ROOT / "src")}
    for mod in ("core/tricode.py", "core/digraph.py", "core/census_ref.py",
                "core/generators.py", "core/planner.py",
                "core/plan_stream.py", "core/census.py", "core/engine.py",
                "core/incremental.py", "core/pair_index.py",
                "core/partition.py", "core/distributed.py",
                "core/faults.py", "core/__init__.py",
                "kernels/build.py", "kernels/census_fused.py",
                "kernels/tricode_hist.py", "kernels/pair_codes.py",
                "kernels/ref.py",
                "kernels/ops.py", "convert.py", "__init__.py"):
        assert f"repro_torch/{mod}" in names, mod


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_pattern_tells_repro_from_repro_torch():
    assert FORBIDDEN.search("from repro.core import planner")
    assert FORBIDDEN.search("import repro\n")
    assert FORBIDDEN.search("    import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.core import planner")
    assert not FORBIDDEN.search("import repro_torch")
