"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no module of it (nor the GPU smoke script, nor the port's
example scripts) imports them.  It exports every name the JAX package's
``repro.core`` does, under the port's names."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + [
    ROOT / "examples" / f"{name}_torch.py"
    for name in ("quickstart", "network_monitor", "census_scaling",
                 "serve_lm", "train_lm")]
#: the JAX package's names the port exports under another name
RENAMED = {"default_mesh": "default_devices"}
#: ``import jax``, ``from jax…``, ``import repro``, ``from repro.…`` —
#: but not ``repro_torch``
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|,|$)",
                       re.MULTILINE)


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.core.distributed, "
            "repro_torch.core.partition, repro_torch.core.faults, "
            "repro_torch.core.plan_stream, repro_torch.core.engine, "
            "repro_torch.core.spans, "
            "repro_torch.core.temporal, repro_torch.analysis, "
            "repro_torch.analysis.report, repro_torch.configs, "
            "repro_torch.configs.registry, repro_torch.models.common, "
            "repro_torch.models.ffn, repro_torch.models.attention, "
            "repro_torch.models.moe, repro_torch.models.recurrent, "
            "repro_torch.models.model, "
            "repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.train, repro_torch.train.optimizer, "
            "repro_torch.train.train_loop, repro_torch.train.checkpoint, "
            "repro_torch.train.fault, repro_torch.data, "
            "repro_torch.data.pipeline, repro_torch.launch.train, "
            "repro_torch.launch.mesh, repro_torch.parallel, "
            "repro_torch.parallel.sharding, repro_torch.parallel.inputs, "
            "repro_torch.parallel.collectives, "
            "repro_torch.parallel.compression, "
            "repro_torch.parallel.pipeline, repro_torch.models.moe_shard, "
            "repro_torch.analysis.roofline, "
            "repro_torch.analysis.collectives, repro_torch.launch.dryrun, "
            "repro_torch.launch.hillclimb\n"
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
                "core/faults.py", "core/temporal.py", "core/spans.py",
                "core/__init__.py",
                "analysis/__init__.py", "analysis/report.py",
                "kernels/build.py", "kernels/census_fused.py",
                "kernels/tricode_hist.py", "kernels/pair_codes.py",
                "kernels/ref.py",
                "kernels/ops.py", "convert.py", "__init__.py",
                "configs/__init__.py", "configs/base.py",
                "configs/registry.py", "models/__init__.py",
                "models/common.py", "models/ffn.py", "models/attention.py",
                "models/moe.py", "models/recurrent.py", "models/model.py",
                "serve/__init__.py",
                "serve/engine.py", "launch/__init__.py", "launch/serve.py",
                "train/__init__.py", "train/optimizer.py",
                "train/train_loop.py", "train/checkpoint.py",
                "train/fault.py", "data/__init__.py", "data/pipeline.py",
                "launch/train.py", "launch/mesh.py", "models/moe_shard.py",
                "parallel/__init__.py", "parallel/sharding.py",
                "parallel/inputs.py", "parallel/collectives.py",
                "parallel/compression.py", "parallel/pipeline.py",
                "analysis/roofline.py", "analysis/collectives.py",
                "launch/dryrun.py", "launch/hillclimb.py"):
        assert f"repro_torch/{mod}" in names, mod


def test_every_reference_config_is_copied():
    ref = ROOT / "src" / "repro" / "configs"
    port = ROOT / "src" / "repro_torch" / "configs"
    names = sorted(p.name for p in ref.glob("*.py"))
    assert len(names) == 13
    for name in names:
        assert (port / name).is_file(), name


def test_examples_exist():
    for path in PORT_FILES[-5:]:
        assert path.is_file(), path


def reference_core_names() -> list[str]:
    """``repro.core.__all__``, read in a process of its own (the JAX
    package imports JAX; the port's import check must not see it)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, repro.core; print(json.dumps(repro.core.__all__))"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120,
        check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_core_exports_cover_the_reference():
    import repro_torch
    import repro_torch.core
    names = reference_core_names()
    assert "TriadMonitor" in names and "default_mesh" in names
    want = {RENAMED.get(name, name) for name in names}
    assert not want - set(repro_torch.core.__all__)
    assert not want - set(repro_torch.__all__)
    for name in want:
        assert getattr(repro_torch.core, name) is getattr(repro_torch, name)


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
