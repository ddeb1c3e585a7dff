from repro_torch.ft.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    restore_into,
    save_checkpoint,
)
from repro_torch.ft.recovery import RecoveryManager
from repro_torch.ft.watchdog import HeartbeatTable, StepWatchdog

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "restore_checkpoint",
    "restore_into",
    "latest_step",
    "RecoveryManager",
    "StepWatchdog",
    "HeartbeatTable",
]
