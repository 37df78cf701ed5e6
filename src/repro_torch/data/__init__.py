"""The deterministic token pipeline (the port of ``repro.data``)."""

from repro_torch.data.pipeline import (
    DataConfig, TokenPipeline, device_batch, host_shard)

__all__ = ["DataConfig", "TokenPipeline", "device_batch", "host_shard"]
