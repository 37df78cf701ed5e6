"""The port's dry run, hill-climb variants and report against the JAX
package's.

* ``run_cell``'s record carries the reference's keys; ``cell_list`` and
  ``VARIANTS`` equal the reference's.
* ``memory.argument_bytes`` equals the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` on (2, 2) for a dense and
  an MoE reduced train step and a decode step.
* The port's global FLOPs (``FlopCounterMode`` over a ``meta`` trace)
  over the reference's lowered ``cost_analysis()["flops"]`` are pinned
  (:data:`FLOPS_RATIO`): XLA counts every op, the counter only matrix
  products.
* The trip-count-multiplied FLOPs of reduced xlstm and recurrentgemma
  equal a full trace.
* The collective model's bytes by kind are pinned to its formulas and
  printed (``-s``) beside the reference's ``collective_summary`` of the
  same compiled cells.
* The report's sections equal the reference's on the same records once
  the hardware prose and the constants are set to the reference's, and
  its ``main`` never writes the repository's ``EXPERIMENTS.md``.
"""

import ast
import dataclasses
import functools
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest

_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun  # noqa: E402 (sets XLA_FLAGS)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags
import repro.analysis.report as ref_report  # noqa: E402
import repro.analysis.roofline as ref_roofline  # noqa: E402
import repro.launch.hillclimb as ref_hillclimb  # noqa: E402
from repro.analysis.hlo import collective_summary  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.models.model import param_schema as ref_param_schema  # noqa
from repro.models.common import tree_paths as ref_tree_paths  # noqa: E402
from repro.parallel.sharding import spec_for_axes as ref_spec  # noqa: E402

import repro_torch.analysis.report as report  # noqa: E402
import repro_torch.analysis.roofline as roofline  # noqa: E402
from repro_torch.analysis.collectives import collective_schedule  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, Q_CHUNK = 8, 64, 32
#: (arch, kind) of the reduced cells compiled on (2, 2)
CELLS = (("qwen2-0.5b", "train"), ("granite-moe-3b-a800m", "train"),
         ("qwen2-0.5b", "decode"))
#: the port's global FLOPs over the reference's lowered count (this
#: container's jax), per cell: FlopCounterMode counts matrix products
#: and XLA every op, so the gap is the elementwise work (norms, softmax,
#: rope, losses; the optimizer)
FLOPS_RATIO = {("qwen2-0.5b", "train"): 0.9796298930356259,
               ("granite-moe-3b-a800m", "train"): 0.9775477680753746,
               ("qwen2-0.5b", "decode"): 0.9339689087050326}
#: the collective model's per-device bytes by kind on those cells
COLLECTIVES = {
    ("qwen2-0.5b", "train"): {"all-reduce": 141568, "all-gather": 2432000,
                              "reduce-scatter": 1968640},
    ("granite-moe-3b-a800m", "train"): {"all-reduce": 921600,
                                        "all-gather": 13148160,
                                        "reduce-scatter": 8931328},
    ("qwen2-0.5b", "decode"): {"all-reduce": 5120, "all-gather": 526848},
}


def ref_mesh():
    return jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def port_mesh():
    return Mesh((2, 2), ("data", "model"))


def cell_kwargs(cfg, kind, cost=False):
    if kind == "decode":
        return {}
    kw = dict(q_chunk=S if cost else Q_CHUNK, seq_shard=not cfg.is_moe)
    if cfg.is_moe and not cost:
        kw["grad_accum"] = 4
    return kw


@functools.lru_cache(maxsize=None)
def ref_cell(arch: str, kind: str) -> dict:
    """The reference's compiled cell on (2, 2): argument bytes, its
    collective summary and its lowered global FLOPs."""
    cfg = ref_get_config(arch).reduced()
    shape = RefShapeSpec("cell", kind, S, B)
    lower = {"train": ref_dryrun._lower_train,
             "decode": ref_dryrun._lower_decode}[kind]
    mesh = ref_mesh()
    compiled, _ = lower(cfg, shape, mesh, **cell_kwargs(cfg, kind))
    lowered, _ = lower(cfg, shape, mesh, scan_layers=False, rec_unroll=True,
                       remat=False, lower_only=True,
                       **cell_kwargs(cfg, kind, cost=True))
    return {"args": compiled.memory_analysis().argument_size_in_bytes,
            "coll": collective_summary(compiled.as_text()),
            "flops": lowered.cost_analysis()["flops"]}


@functools.lru_cache(maxsize=None)
def port_cell(arch: str, kind: str):
    cfg = get_config(arch).reduced()
    shape = ShapeSpec("cell", kind, S, B)
    traced, _ = dryrun._compile(kind, cfg, shape, port_mesh(),
                                **cell_kwargs(cfg, kind))
    cost, _ = dryrun._compile(kind, cfg, shape, port_mesh(), remat=False,
                              lower_only=True,
                              **cell_kwargs(cfg, kind, cost=True))
    return traced, cost


# ------------------------------------------------------------ the record

def reference_record_keys() -> set:
    """Every key the reference's ``run_cell`` writes into its record."""
    tree = ast.parse(Path(ref_dryrun.__file__).read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "rec"
                        for t in node.targets)):
            keys.update(k.value for k in node.value.keys)
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "rec"
                and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def test_run_cell_record_has_the_reference_keys():
    want = reference_record_keys()
    assert {"arch", "memory", "cost_corrected", "collectives",
            "lower_seconds_cost", "overrides"} <= want
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", False)
    assert set(rec) == want - {"overrides"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert set(rec["cost_raw"]) == {"flops", "bytes_accessed"}
    assert set(rec["cost_corrected"]) == {"flops", "bytes_accessed",
                                          "collective_bytes"}
    assert set(rec["collectives"]) == {"bytes_by_kind", "counts_by_kind",
                                       "total_bytes", "total_count"}
    assert rec["cost_scope"] == "global"
    assert rec["cost_method"] == "meta-trace"
    assert rec["devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["memory"]["generated_code_bytes"] == 0
    assert rec["cost_corrected"]["collective_bytes"] == \
        rec["collectives"]["total_bytes"] * 256


def test_cell_list_equals_the_reference():
    assert dryrun.cell_list() == ref_dryrun.cell_list()
    assert len(dryrun.cell_list()) == 32
    assert (dryrun.cell_list(["xlstm-1.3b"])
            == ref_dryrun.cell_list(["xlstm-1.3b"]))


def test_out_dir_is_under_build():
    assert dryrun.OUT_DIR == ROOT / "build" / "dryrun"
    assert hillclimb.OUT == ROOT / "build" / "variants"


# ------------------------------------------------------------ memory, cost

@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_equal_the_reference_compile(arch, kind):
    traced, _ = port_cell(arch, kind)
    assert traced.argument_bytes == ref_cell(arch, kind)["args"]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_over_the_reference_lowering_are_pinned(arch, kind):
    _, cost = port_cell(arch, kind)
    ratio = cost.flops / ref_cell(arch, kind)["flops"]
    print(f"\n{arch} {kind}: port {cost.flops:.6e} / reference "
          f"{ref_cell(arch, kind)['flops']:.6e} = {ratio!r}")
    assert ratio == pytest.approx(FLOPS_RATIO[(arch, kind)], rel=1e-9)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_traced_memory_is_positive_and_bounded(arch, kind):
    """temp + output bytes of the per-device trace: positive, and no more
    than the per-device work could hold."""
    traced, _ = port_cell(arch, kind)
    assert traced.temp_bytes > 0 and traced.output_bytes > 0
    assert traced.flops > 0 and traced.bytes_accessed > 0
    assert traced.temp_bytes < traced.bytes_accessed


def test_tracer_flops_equal_flop_counter_mode():
    """The per-device trace counts FLOPs by ``FlopCounterMode``'s formulas:
    on one device the same as the counter around the same step."""
    cfg = get_config("qwen2-0.5b").reduced()
    shape = ShapeSpec("cell", "train", S, 2)
    one = dryrun._one_device_mesh()
    mine, flops, _ = dryrun._trace_step("train", cfg, shape, one,
                                        q_chunk=Q_CHUNK, remat=True)
    _, counted, _ = dryrun._trace_step("train", cfg, shape, one,
                                       q_chunk=Q_CHUNK, remat=True,
                                       flop_counter=True)
    assert flops == mine.flops == counted > 0


def test_one_device_argument_bytes_are_the_state_and_batch():
    """On one device the arguments are every parameter and moment in
    float32, the int32 step and the int32 tokens and labels."""
    cfg = get_config("qwen2-0.5b").reduced()
    shape = ShapeSpec("cell", "train", S, 4)
    traced, _ = dryrun._compile("train", cfg, shape,
                                dryrun._one_device_mesh(), q_chunk=Q_CHUNK,
                                grad_accum=2)
    n = dryrun.count_params(cfg)
    assert traced.argument_parts == {"params": 4 * n, "opt": 8 * n + 4,
                                     "batch": 2 * 4 * 4 * S}


def test_grad_accum_trace_repeats_from_the_third_micro_batch():
    """Tracing 3 of 4 micro-batches gives the peak of tracing all 4."""
    cfg = get_config("qwen2-0.5b").reduced()
    one = dryrun._one_device_mesh()
    peaks = []
    for rows, accum in ((8, 4), (6, 3)):
        tracer, _, _ = dryrun._trace_step(
            "train", cfg, ShapeSpec("cell", "train", S, rows), one,
            q_chunk=Q_CHUNK, grad_accum=accum, divisors_mesh=one)
        peaks.append(tracer.peak)
    assert peaks[0] == peaks[1]


# ------------------------------------------------------------ trip counts

@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-2b"])
@pytest.mark.parametrize("kind,seq", [("train", 64), ("prefill", 512)])
def test_trip_count_flops_equal_a_full_trace(arch, kind, seq):
    """Counted by trips (the sLSTM over 1 and 2 positions; the mLSTM at
    64 positions padded into one chunk, then at 1 and 2 whole chunks) =
    the whole step traced, FLOPs exactly, unfused bytes nearly."""
    cfg = get_config(arch).reduced()
    shape = ShapeSpec("cell", kind, seq, 2)
    mesh = dryrun._one_device_mesh()
    flops, nbytes = dryrun._global_cost(kind, cfg, shape, mesh,
                                        q_chunk=seq, seq_shard=True,
                                        kv_quant=False)
    tracer, full, _ = dryrun._trace_step(kind, cfg, shape, mesh,
                                         q_chunk=seq, remat=False,
                                         flop_counter=True)
    print(f"\n{arch} {kind} {seq}: flops {flops} (full {full}), bytes "
          f"{nbytes} (full {tracer.bytes_accessed})")
    assert flops == full > 0
    # the residual stream's elementwise traffic between blocks is not in
    # the blocks' counts: 3.9 % of reduced xlstm's train bytes, 0.5 % of
    # its prefill's, none of recurrentgemma's
    assert nbytes == pytest.approx(tracer.bytes_accessed, rel=0.05)


# ------------------------------------------------------------ collectives

@pytest.mark.parametrize("arch,kind", CELLS)
def test_collective_model_is_pinned_and_printed(arch, kind):
    traced, _ = port_cell(arch, kind)
    got = traced.collectives
    want = ref_cell(arch, kind)["coll"]
    print(f"\n{arch} {kind} on (2, 2), bytes by kind per device: port "
          f"model {got['bytes_by_kind']} (total {got['total_bytes']}, "
          f"{got['total_count']} ops); reference HLO "
          f"{dict(want['bytes_by_kind'])} (total {want['total_bytes']}, "
          f"{want['total_count']} ops)")
    assert got["bytes_by_kind"] == COLLECTIVES[(arch, kind)]
    assert got["total_bytes"] == sum(COLLECTIVES[(arch, kind)].values())


@pytest.mark.parametrize("arch,kind", CELLS)
def test_fsdp_gathers_follow_the_reference_placements(arch, kind):
    """The FSDP part of the model, from the reference's own specs: every
    leaf sharded over ``data`` gathered once a pass (forward, backward,
    remat's recompute), at its size over ``model``, in the dtype the
    forward reads it in."""
    ref_cfg = ref_get_config(arch).reduced()
    mesh = ref_mesh()
    shape = ShapeSpec("cell", kind, S, B)
    accum = 4 if ref_cfg.is_moe and kind == "train" else 1
    want = 0
    for path, leaf in ref_tree_paths(ref_param_schema(ref_cfg)):
        spec = tuple(ref_spec(leaf.axes, leaf.shape, mesh))
        flat = {a for p in spec if p is not None
                for a in (p if isinstance(p, tuple) else (p,))}
        if "data" not in flat:
            continue
        in_layer = path[0].startswith("g")
        passes = (3 if in_layer else 2) if kind == "train" else 1
        gathered = int(np.prod(leaf.shape)) // (2 if "model" in flat else 1)
        f32 = any(p in ("norm1", "norm2", "norm_cross", "out_norm")
                  for p in path)
        want += gathered * (4 if f32 else 2) * passes * accum
    # without sequence sharding the model's only all-gathers are FSDP's
    got = collective_schedule(get_config(arch).reduced(), shape,
                              port_mesh(), grad_accum=accum,
                              seq_shard=False)
    assert got["bytes_by_kind"]["all-gather"] == want > 0


def test_shard_map_adds_the_moe_all_to_alls():
    cfg = get_config("granite-moe-3b-a800m").reduced()
    shape = ShapeSpec("cell", "train", S, B)
    mesh = port_mesh()
    gspmd = collective_schedule(cfg, shape, mesh, grad_accum=4)
    smap = collective_schedule(cfg, shape, mesh, grad_accum=4,
                               moe_impl="shard_map")
    assert "all-to-all" not in gspmd["bytes_by_kind"]
    # 2 layers x 3 passes x 4 micro-batches x 2 directions, E x C x d x 2
    tokens = B // 2 // 4 * (S // 2)
    cap = max(int(np.ceil(tokens * cfg.top_k / cfg.num_experts * 1.25)), 4)
    assert smap["counts_by_kind"]["all-to-all"] == 2 * 3 * 4 * 2
    assert smap["bytes_by_kind"]["all-to-all"] == (
        48 * cfg.num_experts * cap * cfg.d_model * 2)


def test_no_collective_on_one_device():
    cfg = get_config("qwen2-0.5b").reduced()
    out = collective_schedule(cfg, ShapeSpec("c", "train", S, B),
                              dryrun._one_device_mesh())
    assert out["total_bytes"] == 0 and out["total_count"] == 0


# ------------------------------------------------------ hill-climb, report

def test_variants_equal_the_reference():
    assert hillclimb.VARIANTS == ref_hillclimb.VARIANTS


@functools.lru_cache(maxsize=None)
def _records(tmp: str) -> tuple:
    return tuple(json.loads(p.read_text())
                 for p in sorted(Path(tmp).glob("*.json")))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """``hillclimb.main(["--cell", "decode"])`` and one ``dryrun.main``
    cell, each writing under a temporary directory."""
    variants = tmp_path_factory.mktemp("variants")
    cells = tmp_path_factory.mktemp("dryrun")
    old = hillclimb.OUT
    hillclimb.OUT = variants
    try:
        hillclimb.main(["--cell", "decode"])
    finally:
        hillclimb.OUT = old
    results = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                           "--shape", "train_4k", "--mesh", "pod", "--out",
                           str(cells)])
    return variants, cells, results


def test_hillclimb_and_dryrun_write_their_records(written):
    variants, cells, results = written
    recs = _records(str(variants))
    assert sorted(p.name for p in variants.glob("*.json")) == [
        "qwen2.5-32b__decode_32k__16x16__kv_int8.json",
        "recurrentgemma-2b__long_500k__16x16__kv_int8_long.json"]
    assert all(r["status"] == "ok" for r in recs)
    assert all(r["overrides"] == {"kv_quant": "True"} for r in recs)
    assert set(recs[0]) == reference_record_keys() | {"status",
                                                      "wall_seconds"}
    assert sorted(p.name for p in cells.glob("*.json")) == [
        "qwen2-0.5b__decode_32k__16x16.json",
        "qwen2-0.5b__train_4k__16x16.json"]
    assert [r["status"] for r in results] == ["ok", "ok"]
    # the int8 cache: fewer argument bytes than the bfloat16 cell's
    plain = dryrun.run_cell("recurrentgemma-2b", "long_500k", False)
    quant = next(r for r in recs if r["arch"] == "recurrentgemma-2b")
    assert quant["memory"]["argument_bytes"] < \
        plain["memory"]["argument_bytes"]


#: the reference's hardware and method prose -> the port's
PROSE = [
    ("lower + compile successfully (SPMD partitioning on 256- and "
     "512-device meshes; XLA CPU backend with "
     "`--xla_force_host_platform_device_count=512`).",
     report.TRACED + "."),
    ("TPU v5e: 197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s/link ICI",
     report.HARDWARE),
    ("FLOPs from the unrolled lowering (scan-free, exact; ×4/3 for train "
     "remat).",
     "FLOPs from the `meta` trace of the whole step (`FlopCounterMode`; "
     "recurrent loops counted one trip × trips; ×4/3 for train remat)."),
    ("pre-fusion HLO byte counts are kept in the JSON as a cross-check but "
     "overstate traffic ~10×.",
     "the trace's unfused per-op byte counts are kept in the JSON as a "
     "cross-check."),
    ("compiled SPMD collectives, while-loop trip-count corrected "
     "(`repro.analysis.hlo`).",
     "the placements' modelled per-device collective schedule "
     "(`repro_torch.analysis.collectives`); 0 on one device."),
]


def patched(text: str) -> str:
    for old, new in PROSE:
        text = text.replace(old, new)
    return text


@pytest.fixture
def reference_constants(monkeypatch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS", ref_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_BW", ref_roofline.ICI_BW)
    monkeypatch.setattr(roofline, "IB_BW", ref_roofline.ICI_BW)
    monkeypatch.setattr(roofline, "DEVICE_MEMORY_GB", 16.0)
    monkeypatch.setattr(roofline, "_SUGGEST", dict(ref_roofline._SUGGEST))


def test_sections_equal_the_reference(written, reference_constants,
                                      monkeypatch, tmp_path):
    variants, cells, _ = written
    recs = list(_records(str(cells))) + list(_records(str(variants))) + [
        {"arch": "x", "shape": "train_4k", "mesh": "16x16",
         "status": "error", "error": "RuntimeError('boom')"}]
    assert report.dryrun_section(recs) == patched(
        ref_report.dryrun_section(recs))
    assert report.roofline_section(recs) == patched(
        ref_report.roofline_section(recs))
    # variants: the reference reads <ROOT>/experiments/variants
    vdir = tmp_path / "experiments" / "variants"
    vdir.mkdir(parents=True)
    for p in variants.glob("*.json"):
        (vdir / p.name).write_text(p.read_text())
    monkeypatch.setattr(ref_report, "ROOT", tmp_path)
    monkeypatch.setattr(report, "VARIANTS_DIR", variants)
    text = report.variants_section()
    assert text == ref_report.variants_section() != ""
    assert "kv_int8" in text


def test_report_main_writes_under_build_only(written, monkeypatch,
                                             tmp_path):
    variants, cells, _ = written
    root_md = ROOT / "EXPERIMENTS.md"
    before = root_md.read_bytes()
    stamp = root_md.stat().st_mtime_ns
    monkeypatch.setattr(report, "DRYRUN", cells)
    monkeypatch.setattr(report, "VARIANTS_DIR", variants)
    monkeypatch.setattr(report, "BUILD", tmp_path)
    monkeypatch.setattr(report, "OUT", tmp_path / "EXPERIMENTS_torch.md")
    report.main([])
    out = tmp_path / "EXPERIMENTS_torch.md"
    text = out.read_text()
    assert "H100 80GB HBM3" in text and "989 TFLOP/s" in text
    assert "3.35 TB/s" in text and "TPU" not in text
    assert "## §Dry-run" in text and "## §Roofline" in text
    report.main(["--out", str(tmp_path / "other.md")])
    assert (tmp_path / "other.md").read_text() == text
    assert root_md.read_bytes() == before
    assert root_md.stat().st_mtime_ns == stamp
    assert report.OUT.parent == tmp_path
    monkeypatch.undo()
    assert report.OUT == ROOT / "build" / "EXPERIMENTS_torch.md"


def test_record_of_a_reduced_config_is_consistent():
    """``_cell_record`` fills the record for any config, shape and mesh:
    a train cell's collectives, global-ized, and its FLOPs near the
    model's 6·N·D."""
    cfg = get_config("qwen2-0.5b").reduced()
    shape = ShapeSpec("cell", "train", S, B)
    rec = dryrun._cell_record(cfg, shape, port_mesh(),
                              {"arch": cfg.name, "devices": 4})
    assert rec["cost_corrected"]["collective_bytes"] == \
        rec["collectives"]["total_bytes"] * 4
    model = roofline._model_flops(cfg, shape)
    assert 0.5 < model / rec["cost_corrected"]["flops"] < 1.5
    row = roofline._analyze(dict(rec, status="ok", shape="cell",
                                 mesh="2x2"), cfg, shape)
    assert row.dominant in ("compute", "memory", "collective")
    assert dataclasses.asdict(row)["fits"]
