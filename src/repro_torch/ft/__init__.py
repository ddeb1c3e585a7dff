from repro_torch.ft.checkpoint import (
    CheckpointManager,
    latest_step,
    place,
    restore_checkpoint,
    restore_into,
    save_checkpoint,
)
from repro_torch.ft.recovery import PeerStepFailed, RecoveryManager, elastic_restore
from repro_torch.ft.watchdog import HeartbeatTable, StepWatchdog

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "restore_checkpoint",
    "restore_into",
    "latest_step",
    "place",
    "RecoveryManager",
    "PeerStepFailed",
    "elastic_restore",
    "StepWatchdog",
    "HeartbeatTable",
]
