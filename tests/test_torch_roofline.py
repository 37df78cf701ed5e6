"""The port's roofline analysis against ``repro.analysis.roofline``: the
work and traffic models equal for every (arch × shape) cell, the row and
table equal once the port's H100 constants are set to the reference's
TPU ones, and the reference's own assertions on the H100."""

import dataclasses

import pytest

import repro.analysis.roofline as ref
import repro_torch.analysis.roofline as port
from repro.configs import all_configs as ref_configs
from repro.configs import shapes_for as ref_shapes_for
from repro_torch.configs import SHAPES, get_config

CELLS = [(arch, shape.name) for arch, cfg in sorted(ref_configs().items())
         for shape in ref_shapes_for(cfg)]

#: the records of ``tests/test_analysis.py``'s ``TestRoofline``
TRAIN_REC = {
    "status": "ok", "arch": "qwen2-0.5b", "shape": "train_4k",
    "mesh": "16x16", "devices": 256,
    "cost_corrected": {"flops": 4.2e15, "bytes_accessed": 3.7e14,
                       "collective_bytes": 4e11},
    "cost_scope": "global",
    "memory": {"temp_bytes": 8.2e9, "argument_bytes": 5.5e7},
}
DECODE_REC = {
    "status": "ok", "arch": "qwen2.5-32b", "shape": "decode_32k",
    "mesh": "16x16", "devices": 256,
    "cost_corrected": {"flops": 8.4e12 / 256, "collective_bytes": 1e7},
    "cost_scope": "per_device",
    "memory": {"temp_bytes": 1e9, "argument_bytes": 1e9},
}
#: a kv_quant decode record on the multi-pod mesh, and a failed one
QUANT_REC = dict(DECODE_REC, mesh="2x16x16", devices=512,
                 overrides={"kv_quant": "True"})
RECORDS = [TRAIN_REC, DECODE_REC, QUANT_REC,
           {"status": "error", "arch": "x", "shape": "train_4k"}]


def test_every_cell_is_covered():
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch,shape", CELLS)
def test_work_and_traffic_models_equal_the_reference(arch, shape):
    assert port.model_flops(arch, shape) == ref.model_flops(arch, shape)
    for kv in (2.0, 1.125):
        assert (port.analytic_hbm_bytes(arch, shape, kv)
                == ref.analytic_hbm_bytes(arch, shape, kv))
    s = SHAPES[shape]
    for kv in (2.0, 1.125):
        assert (port._cache_bytes(get_config(arch), s.global_batch,
                                  s.seq_len, kv)
                == ref._cache_bytes(ref_configs()[arch], s.global_batch,
                                    s.seq_len, kv))


@pytest.fixture
def tpu_constants(monkeypatch):
    """The port's constants and notes set to the reference's."""
    monkeypatch.setattr(port, "PEAK_FLOPS", ref.PEAK_FLOPS)
    monkeypatch.setattr(port, "HBM_BW", ref.HBM_BW)
    monkeypatch.setattr(port, "NVLINK_BW", ref.ICI_BW)
    monkeypatch.setattr(port, "IB_BW", ref.ICI_BW)
    monkeypatch.setattr(port, "DEVICE_MEMORY_GB", 16.0)
    monkeypatch.setattr(port, "_SUGGEST", dict(ref._SUGGEST))


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: str(r.get("shape"))
                         + "-" + str(r.get("mesh", r["status"])))
def test_analyze_record_equals_the_reference_at_its_constants(
        rec, tpu_constants):
    got, want = port.analyze_record(rec), ref.analyze_record(rec)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_markdown_table_equals_the_reference_at_its_constants(
        tpu_constants):
    rows = [r for r in map(port.analyze_record, RECORDS) if r is not None]
    want = [r for r in map(ref.analyze_record, RECORDS) if r is not None]
    assert port.markdown_table(rows) == ref.markdown_table(want)
    assert port.fmt_seconds(2.5) == ref.fmt_seconds(2.5)
    assert port.fmt_seconds(2.5e-3) == ref.fmt_seconds(2.5e-3)
    assert port.fmt_seconds(2.5e-6) == ref.fmt_seconds(2.5e-6)


def test_reference_assertions_hold_on_the_h100():
    """``TestRoofline``'s own checks, with the H100's constants."""
    assert (port.model_flops("qwen2-0.5b", "train_4k")
            > port.model_flops("qwen2-0.5b", "decode_32k") * 1000)
    row = port.analyze_record(TRAIN_REC)
    assert row.dominant in ("compute", "memory", "collective")
    assert row.fits
    assert 0 < row.roofline_frac <= 1.5
    assert 0.2 < row.useful_ratio < 1.5
    assert port.analyze_record(DECODE_REC).dominant == "memory"
    assert port.analyze_record(QUANT_REC).dominant == "memory"
    # the same cell at 81 GB of a device does not fit the card
    big = dict(TRAIN_REC, memory={"temp_bytes": 81e9,
                                  "argument_bytes": 5.5e7})
    assert not port.analyze_record(big).fits


def test_h100_constants_are_the_data_sheet_figures():
    assert port.PEAK_FLOPS == 989e12 and port.HBM_BW == 3.35e12
    assert port.NVLINK_BW == 450e9 and port.IB_BW == 50e9
    assert port.DEVICE_MEMORY_GB == 80.0
    assert port.REMAT_FACTOR == ref.REMAT_FACTOR
    assert set(port._SUGGEST) == set(ref._SUGGEST)


def test_link_term_by_mesh_size():
    one = dict(TRAIN_REC, mesh="1x1", devices=1)
    assert port.analyze_record(one).collective_s == 0.0
    node = dict(TRAIN_REC, mesh="2x4", devices=8)
    assert port.analyze_record(node).collective_s == pytest.approx(
        4e11 / (8 * port.NVLINK_BW))
    pod = port.analyze_record(TRAIN_REC)
    assert pod.collective_s == pytest.approx(4e11 / (256 * port.IB_BW))


def test_analyze_takes_a_shape_outside_the_named_ones():
    """``_analyze`` of a one-card shape, as the GPU smoke builds it."""
    from repro_torch.configs.base import ShapeSpec
    cfg = get_config("qwen2-0.5b")
    shape = ShapeSpec("card", "decode", 576, 8)
    rec = dict(DECODE_REC, arch="qwen2-0.5b", shape="card", mesh="1x1",
               devices=1, cost_scope="global",
               cost_corrected={"flops": 1e10, "collective_bytes": 0.0})
    row = port._analyze(rec, cfg, shape)
    assert row.memory_s == pytest.approx(
        port._hbm_bytes(cfg, shape) / port.HBM_BW)
    assert row.collective_s == 0.0 and row.dominant == "memory"
