"""Three-term roofline analysis from the dry-run records, on the H100.

The port of ``repro.analysis.roofline``, formula for formula, with the
card's constants in place of the TPU's.  Per (arch × shape × mesh) cell::

    compute_term    = FLOPs      / (devices × 989 TFLOP/s bf16)
    memory_term     = HBM_bytes  / (devices × 3.35 TB/s)
    collective_term = coll_bytes / (devices × link bandwidth)

The constants are the NVIDIA H100 SXM 80GB data sheet's (the card at its
700 W limit): 989e12 dense bfloat16 FLOP/s and 3.35e12 bytes/s of HBM3.
The link term reads one of two named figures, by the mesh's size:
:data:`NVLINK_BW` (NVLink 4, 450 GB/s each direction per GPU) for a mesh
that fits one 8-GPU node, :data:`IB_BW` (one 400 Gb/s NDR InfiniBand
port per GPU, 50 GB/s) for a larger one — a 16-wide mesh axis spans two
nodes, so every production mesh is on InfiniBand.  The term is 0 on one
device.  ``fits`` reads the card's 80 GB.

FLOPs come from the dry run's ``meta`` trace of the whole step
(``torch.utils.flop_counter.FlopCounterMode``: matrix products only;
remat off, multiplied by 4/3 for train cells to account for remat's
recompute, which the production step enables).  The HBM byte term is the
reference's analytic traffic model (weights + optimizer + activation
streams + KV cache); the trace's unfused per-op byte count is carried in
the record as a cross-check.  Collective bytes come from the analytic
schedule of the step's placements (``repro_torch.analysis.collectives``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.models.model import count_params, layer_sigs

PEAK_FLOPS = 989e12        # dense bf16 FLOP/s / GPU (H100 SXM data sheet)
HBM_BW = 3.35e12           # bytes/s / GPU (H100 SXM data sheet)
NVLINK_BW = 450e9          # bytes/s / GPU each direction, NVLink 4
IB_BW = 50e9               # bytes/s / GPU, one 400 Gb/s NDR IB port
NODE_GPUS = 8              # GPUs one NVLink domain (an HGX node) holds
DEVICE_MEMORY_GB = 80.0    # HBM3 / GPU
REMAT_FACTOR = 4.0 / 3.0   # fwd recompute on top of fwd+bwd


def link_bw(devices: int) -> float:
    """The link bandwidth a mesh of ``devices`` GPUs crosses: NVLink
    within one node, InfiniBand past it."""
    return NVLINK_BW if devices <= NODE_GPUS else IB_BW


def model_flops(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active
    params."""
    return _model_flops(get_config(arch), SHAPES[shape_name])


def _model_flops(cfg, shape) -> float:
    n_active = count_params(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch                 # one decode step
    return 2.0 * n_active * tokens


def analytic_hbm_bytes(arch: str, shape_name: str,
                       kv_bytes: float = 2.0) -> float:
    """Global HBM traffic per step (napkin model, documented in module
    docstring). ``kv_bytes``: bytes/element of the KV cache (2 = bf16,
    1.125 = int8 + scales — the kv_quant variant)."""
    return _hbm_bytes(get_config(arch), SHAPES[shape_name], kv_bytes)


def _hbm_bytes(cfg, shape, kv_bytes: float = 2.0) -> float:
    p = count_params(cfg)
    p_active = count_params(cfg, active_only=True)
    d, L = cfg.d_model, cfg.num_layers

    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        # weights: fwd read + bwd read + remat re-read (bf16) for ALL
        # params (moe experts stream from HBM even if inactive per token
        # at full batch every expert is hit)
        w = p * 2 * 3
        # optimizer: grads (f32 w+r) + mu/nu read+write + param read+write
        opt = p * 4 * (2 + 4 + 2)
        # activation streams: ~14 tensor rw per layer element + remat
        act = tokens * d * L * 14 * 2 * 1.5
        return w + opt + act
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        w = p * 2
        act = tokens * d * L * 10 * 2
        kv = tokens * cfg.num_kv_heads * cfg.head_dim * 2 * L * 2 * 2
        return w + act + kv
    # decode: every step reads all (active) weights + the whole KV/state
    b = shape.global_batch
    w = p_active * 2 + (p - p_active) * 2 * min(
        1.0, b * max(cfg.top_k, 1) / max(cfg.num_experts, 1))
    kv = _cache_bytes(cfg, b, shape.seq_len, kv_bytes)
    act = b * d * L * 14 * 2
    return w + kv + act


def _cache_bytes(cfg, batch: int, seq_len: int,
                 kv_bytes: float = 2.0) -> float:
    total = 0.0
    for kind, _ in layer_sigs(cfg):
        if kind == "attn":
            total += (2 * batch * seq_len * cfg.num_kv_heads *
                      cfg.head_dim * kv_bytes)
        elif kind == "local_attn":
            s = min(seq_len, cfg.window or seq_len)
            total += (2 * batch * s * cfg.num_kv_heads * cfg.head_dim *
                      kv_bytes)
        elif kind == "mlstm":
            di = 2 * cfg.d_model
            k = di // cfg.num_heads
            total += batch * cfg.num_heads * (k * k + k + 1) * 4
        elif kind == "slstm":
            total += batch * cfg.d_model * 4 * 4
        elif kind == "rglru":
            total += batch * cfg.lru_width * 4 * cfg.conv1d_width
    if cfg.is_encdec:
        total *= 1.5      # cross K/V
    return total


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float
    useful_ratio: float
    fits: bool
    temp_gb: float
    step_time_s: float
    roofline_frac: float
    note: str


_SUGGEST = {
    "compute": ("shard padding waste / improve tensor-core utilization "
                "(head-dim alignment, fused kernels)"),
    "memory": ("cut HBM traffic: larger fused blocks, KV-cache "
               "quantization, weight layout reuse across steps"),
    "collective": ("reshard to cut cross-device volume: fewer FSDP "
                   "gathers (TP-first), overlap collectives with compute, "
                   "gradient compression"),
}


def analyze_record(rec: dict) -> RooflineRow | None:
    if rec.get("status") != "ok":
        return None
    return _analyze(rec, get_config(rec["arch"]), SHAPES[rec["shape"]])


def _analyze(rec: dict, cfg, shape) -> RooflineRow:
    """:func:`analyze_record` of a record whose config and shape are given
    (a one-card shape need not be one of ``SHAPES``)."""
    chips = rec["devices"]
    cc = rec["cost_corrected"]
    scope = rec.get("cost_scope", "global")
    mult = 1.0 if scope == "global" else chips
    hlo_flops = cc.get("flops", 0.0) * mult
    coll_bytes = cc.get("collective_bytes", 0.0)
    if scope == "per_device":
        coll_bytes = coll_bytes * chips

    remat = REMAT_FACTOR if shape.kind == "train" else 1.0
    compute_s = hlo_flops * remat / (chips * PEAK_FLOPS)
    kv_bytes = (1.125 if str(rec.get("overrides", {}).get(
        "kv_quant")) == "True" else 2.0)
    memory_s = _hbm_bytes(cfg, shape, kv_bytes) / (chips * HBM_BW)
    collective_s = (0.0 if chips == 1 else
                    coll_bytes / (chips * link_bw(chips)))

    mf = _model_flops(cfg, shape)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step = max(terms.values())
    # roofline fraction: useful-compute time over the modeled step time
    ideal_compute = mf / (chips * PEAK_FLOPS)
    frac = ideal_compute / step if step > 0 else 0.0
    temp_gb = rec["memory"]["temp_bytes"] / 1e9
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, hlo_flops=hlo_flops,
        useful_ratio=mf / hlo_flops if hlo_flops else 0.0,
        fits=(temp_gb + rec["memory"]["argument_bytes"] / 1e9
              < DEVICE_MEMORY_GB),
        temp_gb=temp_gb, step_time_s=step, roofline_frac=frac,
        note=_SUGGEST[dominant])


def load_records(dryrun_dir) -> list[dict]:
    out = []
    for p in sorted(Path(dryrun_dir).glob("*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except json.JSONDecodeError:
            continue
    return out


def fmt_seconds(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.1f}ms"
    return f"{s * 1e6:.0f}µs"


def markdown_table(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | mesh | compute | memory | collective | "
           "dominant | MF/HLO | roofline frac | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | "
            f"{fmt_seconds(r.compute_s)} | {fmt_seconds(r.memory_s)} | "
            f"{fmt_seconds(r.collective_s)} | **{r.dominant}** | "
            f"{r.useful_ratio:.2f} | {r.roofline_frac:.1%} | "
            f"{'✓' if r.fits else '✗'} |")
    return hdr + "\n".join(lines)
