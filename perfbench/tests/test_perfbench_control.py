"""The comparison's control: the reference in the program's place with
its counts in int32 comes out not correct, where the program's timed
path reads 0.  At the cells' own sizes this runs on the card
(``perfbench/control.py``); here at 3,000 vertices, where C(n, 3)
passes 2**31."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

from perfbench import control, harness  # noqa: E402
from perfbench_tiny import tiny_tree  # noqa: E402


@pytest.mark.parametrize("cell", ["patents.census", "patents.update"])
def test_control_fails_where_the_program_reads_zero(tmp_path, cell,
                                                   monkeypatch):
    # a test worker may hold jax from another file (see the isolation test)
    monkeypatch.setattr(harness, "FORBIDDEN", frozenset())
    root = tiny_tree(tmp_path / "perfbench", max_items=2**14, k=20,
                     sizes={"cit-patents": 3000})
    got = control.readings(cell, 2**31 + 77, 0.2, torch.device("cpu"),
                           root=root)
    assert got["calls"] >= 1 and got["compared"] >= 1
    assert got["program_gap"] == 0
    assert got["control_gap"] > 0


@pytest.mark.cuda
def test_reference_on_the_card_equals_the_cpu(cuda):
    from perfbench import graphs, reference
    src, dst = graphs.scale_free_edges(5000, 6.0, 2.127, 0.5,
                                       graphs.generator(4, "cpu"))
    keys = reference.arc_keys(src, dst, 5000)
    assert reference.census(keys.to(cuda), 5000, block=4096) == \
        reference.census(keys, 5000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
