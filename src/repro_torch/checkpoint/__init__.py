"""Host-object snapshots and the serving journal on disk (port of the
blob and journal half of ``repro.checkpoint.store``)."""

from .store import BlobLog, BlobLogFollower, latest_step, load_blob, save_blob

__all__ = ["save_blob", "load_blob", "latest_step", "BlobLog",
           "BlobLogFollower"]
