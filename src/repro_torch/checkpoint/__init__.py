"""Checkpoints of tensor trees, host-object snapshots and the serving
journal on disk (port of ``repro.checkpoint.store``)."""

from .store import (BlobLog, BlobLogFollower, CheckpointManager, latest_step,
                    load_blob, restore_state, save_blob, save_state)

__all__ = ["save_state", "restore_state", "CheckpointManager", "save_blob",
           "load_blob", "latest_step", "BlobLog", "BlobLogFollower"]
