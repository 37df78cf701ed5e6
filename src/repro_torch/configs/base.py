"""Architecture config system: one frozen dataclass per assigned arch.

The port's copy of ``repro.configs.base``, field for field, so that a
config of either package describes the same model.  Every config is
registered under its public id and selectable via ``--arch <id>`` in the
launchers. ``reduced()`` returns a tiny same-family config for CPU tests;
a full config is served on the card (``repro_torch.serve.engine``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: (kind, seq_len, global_batch)."""
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


#: The assigned LM shape set (applies to every architecture).
SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    rope_variant: str = "rope"       # rope | mrope | none
    rope_theta: float = 10_000.0
    window: int = 0                  # local-attention window (0 = full)
    logit_softcap: float = 0.0

    # ffn
    ffn_activation: str = "swiglu"   # swiglu | gelu | sq_relu | geglu

    # moe
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    first_layer_dense: bool = False  # deepseek-moe layer 0
    dense_d_ff: int = 0              # d_ff of that dense layer
    router_aux_coef: float = 0.01

    # layer pattern, cycled: attn | local_attn | mlstm | slstm | rglru
    block_pattern: tuple = ("attn",)

    # encoder-decoder
    encoder_layers: int = 0
    # recurrent
    lru_width: int = 0
    conv1d_width: int = 4
    # misc
    modality: str = "text"           # text | audio | vlm
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    sub_quadratic: bool = False      # may run long_500k
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name
        assert len(self.block_pattern) > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def pattern_for(self, num_layers: int) -> tuple:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(num_layers))

    def param_count(self) -> int:
        """Exact parameter count (embedding + blocks), for 6·N·D rooflines."""
        from repro_torch.models.model import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            num_layers=max(2, len(self.block_pattern)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads > 1
            else 1,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            window=min(self.window, 64) if self.window else 0,
            lru_width=128 if self.lru_width else 0,
        )
        if self.is_moe:
            changes.update(num_experts=4, top_k=2,
                           num_shared_experts=min(self.num_shared_experts, 1))
        if self.is_encdec:
            changes.update(encoder_layers=2)
        return dataclasses.replace(self, **changes)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


def shapes_for(cfg: ArchConfig) -> list[ShapeSpec]:
    """The applicable shape cells for an arch (skip rules per DESIGN.md)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out


def _ensure_loaded():
    # import every config module once so registration side effects run
    import repro_torch.configs.registry  # noqa: F401
