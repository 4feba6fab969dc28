"""Request lifecycle: statuses, admission validation, per-request rows.

A copy of the subset of ``repro.launch.lifecycle`` the engine's main
path uses.  Priority classes, SLO targets and class quotas are not
ported yet (ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import enum
import time

import numpy as np

__all__ = ["RequestStatus", "validate_request", "request_row", "now"]


class RequestStatus(str, enum.Enum):
    """Where a request is in its lifecycle (str-valued for JSON/stats)."""

    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"
    COMPLETED = "completed"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"


def validate_request(prompt, *, vocab: int, temperature=None,
                     top_k=None) -> np.ndarray:
    """Admission-time validation; returns the prompt as int32.

    Rejects non-integer token ids, out-of-vocab ids, and negative
    ``temperature`` / ``top_k`` (scalars or ``{slot: v}`` dicts).
    """
    p = np.asarray(prompt)
    if p.ndim > 1:
        p = p.reshape(-1)
    if p.size and not np.issubdtype(p.dtype, np.integer):
        if not (np.issubdtype(p.dtype, np.floating)
                and np.all(np.isfinite(p)) and np.all(p == np.floor(p))):
            raise ValueError(
                f"prompt token ids must be integers (got dtype {p.dtype} "
                f"with non-integral values); refusing to truncate")
    p = p.astype(np.int64, copy=False)
    if p.size and (int(p.min()) < 0 or int(p.max()) >= vocab):
        bad = p[(p < 0) | (p >= vocab)][0]
        raise ValueError(
            f"prompt contains out-of-vocab token id {int(bad)} "
            f"(vocab={vocab}); the embedding gather would read garbage")

    def each(v):
        vals = v.values() if isinstance(v, dict) else [v]
        return [x for x in vals if x is not None]

    for x in each(temperature):
        if float(x) < 0:
            raise ValueError(
                f"negative temperature {x} (0 = greedy; negative would "
                f"invert the sampling distribution)")
    for x in each(top_k):
        if int(x) < 0:
            raise ValueError(f"negative top_k {x} (0 disables the filter)")
    return p.astype(np.int32)


def request_row(*, ttft_s: float, gen_tokens: int, decode_s: float,
                status: RequestStatus) -> dict:
    """One ``Engine.request_log`` row; ``tok_per_s`` is None (not 0.0)
    when the decode interval is not measurable."""
    return {"ttft_s": float(ttft_s), "gen_tokens": int(gen_tokens),
            "decode_s": float(decode_s), "status": status.value,
            "tok_per_s": (gen_tokens / decode_s) if decode_s > 0 else None}


def now() -> float:
    """Engine wall clock."""
    return time.perf_counter()
