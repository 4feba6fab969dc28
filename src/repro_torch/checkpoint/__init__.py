"""Host-object snapshots on disk (port of the blob half of
``repro.checkpoint.store``)."""

from .store import latest_step, load_blob, save_blob

__all__ = ["save_blob", "load_blob", "latest_step"]
