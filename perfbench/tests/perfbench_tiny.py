"""A copy of the benchmark's tree, and of ``BENCHMARK.json`` beside it,
with its graphs cut to CPU-test size."""

import json
import shutil
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
#: vertices of each configuration in the tiny tree
TINY_N = {"cit-patents": 300, "orkut-hub": 120}


def tiny_tree(dest: Path, max_items: int = 2**10, k: int = 5,
              sizes: dict | None = None) -> Path:
    """``dest`` holding the benchmark's files, each configuration cut to
    ``TINY_N`` vertices (or ``sizes``), an arc count in proportion, and
    each traffic mix to ``max_items`` items a window and ``k`` arcs a
    delta."""
    shutil.copytree(PERFBENCH, dest,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(PERFBENCH.parent / "BENCHMARK.json", dest.parent)
    for path in (dest / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        n = {**TINY_N, **(sizes or {})}[path.stem]
        if "arcs" in cfg:
            cfg["arcs"] = round(cfg["arcs"] * n / cfg["n"])
        cfg["n"] = n
        path.write_text(json.dumps(cfg))
    for path in (dest / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic["max_items"] = max_items
        if "k" in traffic:
            traffic["k"] = k
        path.write_text(json.dumps(traffic))
    return dest
