"""Atomic snapshots of host objects (port of ``save_blob``, ``load_blob``
and ``latest_step`` of ``repro.checkpoint.store``).

One directory per step, ``<dir>/step_%08d/``, holding the object as one
pickled ``.npy`` and a ``manifest.json``; a save writes ``<step>.tmp``
and renames it, so a crash mid-save never corrupts the newest complete
snapshot.  Pickle: only for trusted, self-written state.  The durable
journal (``BlobLog``) is ROADMAP.md queue 1, item 12b.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

__all__ = ["save_blob", "load_blob", "latest_step"]


def save_blob(obj, directory: str, step: int, *, name: str = "blob") -> str:
    """Atomically persist ``obj``; returns the step directory."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arr = np.empty((), dtype=object)
    arr[()] = obj
    np.save(os.path.join(tmp, name + ".npy"), arr, allow_pickle=True)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "blob": name + ".npy"}, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_blob(directory: str, step: int, *, name: str = "blob"):
    """Load a :func:`save_blob` snapshot."""
    path = os.path.join(directory, f"step_{step:08d}", name + ".npy")
    return np.load(path, allow_pickle=True)[()]


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under ``directory`` (None: none)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None
