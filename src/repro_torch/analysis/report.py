"""Markdown sections on census runs.

The port's counterpart of the JAX package's ``analysis/report.py``; it
holds the one section a census run reports, :func:`streaming_section`,
and gives the same text for the same stats fields.
"""

from __future__ import annotations

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
