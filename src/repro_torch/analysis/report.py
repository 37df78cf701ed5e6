"""Generate the EXPERIMENTS sections (§Dry-run, §Roofline) from the
dry-run JSON records, and the section a census run reports.

The port of ``repro.analysis.report``: the same text for the same
records and stats fields, with the H100 named in place of the TPU and
the records read from ``meta`` traces (``repro_torch.launch.dryrun``)
in place of XLA compiles.  :func:`main` writes
``build/EXPERIMENTS_torch.md`` (or ``--out``), never the repository's
``EXPERIMENTS.md``.

    PYTHONPATH=src python -m repro_torch.analysis.report
"""

from __future__ import annotations

import argparse
from collections import Counter
from pathlib import Path

from repro_torch.analysis.roofline import (
    analyze_record, fmt_seconds, load_records, markdown_table)

ROOT = Path(__file__).resolve().parents[3]
BUILD = ROOT / "build"
DRYRUN = BUILD / "dryrun"
VARIANTS_DIR = BUILD / "variants"
OUT = BUILD / "EXPERIMENTS_torch.md"

#: the hardware and method the prose names
HARDWARE = ("H100 80GB HBM3 (SXM, 700 W): 989 TFLOP/s bf16, 3.35 TB/s "
            "HBM, 450 GB/s/GPU NVLink 4 within an 8-GPU node, 50 GB/s/GPU "
            "InfiniBand (400 Gb/s NDR) across nodes")
TRACED = ("trace on `meta` (no device memory; placements on 256- and "
          "512-device meshes, `repro_torch.parallel.sharding`; per-device "
          "step for memory, global step for cost)")

#: per-chunk rows shown before eliding the middle of a long schedule
_MAX_CHUNK_ROWS = 16


def streaming_section(stats) -> str:
    """Markdown for a streamed census run — the paper's Fig-9-style
    utilization analysis extended to the chunked schedule.

    ``stats`` is a :class:`repro_torch.core.engine.EngineStats` (or
    anything with the same fields).  Per-chunk valid-item counts are the
    streamed analogue of per-shard work shares: ``chunk_max_over_mean``
    close to 1.0 means the pre-prune slicing produced an even device
    schedule.
    """
    items = list(stats.chunk_items)
    lines = [
        "### §Streaming schedule",
        "",
        f"backend={stats.backend} devices={stats.ndev} "
        f"orient={stats.orient} max_items={stats.max_items} — "
        f"{stats.chunks} chunks, {stats.items} work items, "
        f"peak plan bytes {stats.peak_plan_bytes} "
        f"(monolithic would ship {stats.monolithic_plan_bytes}), "
        f"chunk step compiles: {stats.step_compiles}",
        "",
        "| chunk | valid items | share of padded shape |",
        "|---|---|---|",
    ]
    shape = max(stats.chunk_shape, 1)
    show = (range(len(items)) if len(items) <= _MAX_CHUNK_ROWS else
            list(range(_MAX_CHUNK_ROWS // 2))
            + [None]
            + list(range(len(items) - _MAX_CHUNK_ROWS // 2, len(items))))
    for k in show:
        if k is None:
            lines.append("| … | … | … |")
        else:
            lines.append(f"| {k} | {items[k]} | {items[k] / shape:.1%} |")
    lines += [
        "",
        f"chunk max-over-mean imbalance: "
        f"{stats.chunk_max_over_mean:.4f} (1.0 == perfectly even)",
    ]
    return "\n".join(lines)


def dryrun_section(records: list[dict]) -> str:
    ok = [r for r in records if r.get("status") == "ok"]
    bad = [r for r in records if r.get("status") != "ok"]
    lines = [
        "## §Dry-run",
        "",
        f"{len(ok)} / {len(records)} (arch × shape × mesh) cells "
        f"{TRACED}.",
        "",
        "| arch | shape | mesh | compile s | args/dev | temp/dev | "
        "collective bytes/dev/step (trip-corrected) | top collectives |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(ok, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        mem = r["memory"]
        coll = r["collectives"]
        top = ", ".join(
            f"{k}×{v}" for k, v in sorted(
                coll["counts_by_kind"].items(),
                key=lambda kv: -coll["bytes_by_kind"].get(kv[0], 0))[:3])
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('compile_seconds', '?')} | "
            f"{mem['argument_bytes'] / 1e9:.2f} GB | "
            f"{mem['temp_bytes'] / 1e9:.2f} GB | "
            f"{coll['total_bytes'] / 1e9:.2f} GB | {top} |")
    if bad:
        lines += ["", "Failures:", ""]
        for r in bad:
            lines.append(f"* {r['arch']} × {r['shape']} × {r['mesh']}: "
                         f"`{r.get('error', '?')[:200]}`")
    lines += [
        "",
        "Skipped by design (DESIGN.md §5): `long_500k` for the 8 pure "
        "full-attention archs (quadratic attention at 524k context is "
        "architecturally excluded; run for xlstm-1.3b and "
        "recurrentgemma-2b).",
    ]
    return "\n".join(lines)


def roofline_section(records: list[dict]) -> str:
    rows = [analyze_record(r) for r in records]
    rows = [r for r in rows if r is not None]
    rows.sort(key=lambda r: (r.mesh, r.arch, r.shape))
    pod = [r for r in rows if r.mesh == "16x16"]
    dom = Counter(r.dominant for r in pod)
    lines = [
        "## §Roofline",
        "",
        f"Terms per the brief ({HARDWARE}):",
        "",
        "* `compute = HLO_FLOPs / (chips × peak)` — FLOPs from the "
        "`meta` trace of the whole step (`FlopCounterMode`; recurrent "
        "loops counted one trip × trips; ×4/3 for train remat).",
        "* `memory = HBM_bytes / (chips × bw)` — analytic traffic model "
        "(weights + optimizer + activation streams + KV/state caches); "
        "the trace's unfused per-op byte counts are kept in the JSON as a "
        "cross-check.",
        "* `collective = bytes / (chips × link_bw)` — the placements' "
        "modelled per-device collective schedule "
        "(`repro_torch.analysis.collectives`); 0 on one device.",
        "",
        "`MF/HLO` = MODEL_FLOPS / HLO_FLOPs with MODEL_FLOPS = 6·N_active·D "
        "(train) or 2·N_active·D (serve); the gap below 1.0 is attention "
        "quadratic work + GQA/MoE overheads, above ~1.0 would flag lost "
        "useful work. `roofline frac` = ideal useful-compute time / "
        "dominant-term time — the score we hillclimb in §Perf.",
        "",
        f"Dominant-term census over single-pod cells: "
        + ", ".join(f"{k}: {v}" for k, v in dom.most_common()),
        "",
        "### Single pod (16×16 = 256 chips)",
        "",
        markdown_table([r for r in rows if r.mesh == "16x16"]),
        "",
        "### Multi-pod (2×16×16 = 512 chips; DP over `pod`)",
        "",
        markdown_table([r for r in rows if r.mesh == "2x16x16"]),
        "",
        "### Per-cell bottleneck notes (single pod)",
        "",
    ]
    for r in pod:
        lines.append(
            f"* **{r.arch} × {r.shape}** — dominant: {r.dominant} "
            f"({fmt_seconds(r.step_time_s)}/step). {r.note}.")
    return "\n".join(lines)


def variants_section() -> str:
    vdir = VARIANTS_DIR
    if not vdir.exists():
        return ""
    recs = [r for r in load_records(vdir) if r.get("status") == "ok"]
    if not recs:
        return ""
    lines = [
        "### §Perf variant measurements (iteration log below)",
        "",
        "| arch | shape | variant | compute | memory | collective | "
        "dominant | frac | temp/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        row = analyze_record(rec)
        if row is None:
            continue
        lines.append(
            f"| {row.arch} | {row.shape} | {rec.get('variant', '?')} | "
            f"{fmt_seconds(row.compute_s)} | {fmt_seconds(row.memory_s)} |"
            f" {fmt_seconds(row.collective_s)} | {row.dominant} | "
            f"{row.roofline_frac:.1%} | {row.temp_gb:.1f} GB | "
            f"{'✓' if row.fits else '✗'} |")
    lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    records = load_records(DRYRUN)
    out = [
        "# EXPERIMENTS",
        "",
        "Artifacts: `build/dryrun/*.json` (one per cell), "
        "`build/variants/*.json` (§Perf iterations). Hardware target: "
        f"{HARDWARE}; records from `meta` traces on the host "
        "(`repro_torch.launch.dryrun`: no device memory allocated).",
        "",
        dryrun_section(records),
        "",
        roofline_section(records),
        "",
        variants_section(),
    ]
    for name in ("PERF_LOG.md", "PAPER_VALIDATION.md"):
        extra = BUILD / name
        if extra.exists():
            out.append(extra.read_text())
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(out))
    print(f"wrote {path} with {len(records)} records")


if __name__ == "__main__":
    main()
