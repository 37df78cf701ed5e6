"""Training: the optimizers, the train step, checkpoints and the fault
coordinator (the port of ``repro.train``)."""

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import (
    Coordinator, StepTimeoutError, StragglerDetector, Watchdog,
    is_device_error)
from repro_torch.train.optimizer import (
    OptConfig, apply_update, global_norm, init_state, schedule, tree_leaves)
from repro_torch.train.train_loop import build_train_step

__all__ = ["CheckpointManager", "Coordinator", "StepTimeoutError",
           "StragglerDetector", "Watchdog", "is_device_error", "OptConfig",
           "apply_update", "global_norm", "init_state", "schedule",
           "tree_leaves", "build_train_step"]
