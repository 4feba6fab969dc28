"""Request lifecycle: statuses, priority classes, SLO targets, admission
validation, per-request rows (port of ``repro.launch.lifecycle``).

A request moves through

::

    QUEUED ──> RUNNING ──> COMPLETED
       │          │ ├────> CANCELLED   (cancel(req_id))
       │          │ ├────> TIMED_OUT   (deadline passed at a block boundary)
       │          │ ├────> FAILED      (device fault lane, no recovery path)
       │          │ └────> PREEMPTED ──> QUEUED   (pages spilled to host)
       ├────────> CANCELLED
       └────────> TIMED_OUT

Every terminal transition returns the tokens the request committed
(``Engine.results[req_id]``); exceptions are for caller errors and
unrecoverable engine faults.  ``PREEMPTED`` is the one non-terminal exit:
the request re-enters the queue with its full restart state, so resuming
it is a restore, never a recompute.

``normalize_class_quotas`` validates the per-class floors and caps that
partition a paged engine's page pool.
"""

from __future__ import annotations

import enum
import time

import numpy as np

__all__ = ["RequestStatus", "TERMINAL_STATUSES", "PriorityClass",
           "coerce_priority", "normalize_slo_targets",
           "normalize_class_quotas", "validate_request",
           "request_row", "now"]


class RequestStatus(str, enum.Enum):
    """Where a request is in its lifecycle (str-valued for JSON/stats)."""

    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"
    COMPLETED = "completed"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"


#: statuses a request never leaves
TERMINAL_STATUSES = frozenset({
    RequestStatus.COMPLETED, RequestStatus.CANCELLED,
    RequestStatus.TIMED_OUT, RequestStatus.FAILED,
})


class PriorityClass(enum.IntEnum):
    """SLO class of a request: a scheduling property, never a sampling one.

    Lower value = more important.  The admission queue serves the
    lowest-valued non-empty class first (FIFO within a class), victims
    spill in descending value, and SLO shedding spends the budgets of
    high-valued classes first.
    """

    REALTIME = 0
    STANDARD = 1
    BATCH = 2


def coerce_priority(value) -> PriorityClass:
    """A :class:`PriorityClass`, its int value or its name (any case);
    ``None`` is STANDARD.  Anything else raises, naming the choices."""
    if value is None:
        return PriorityClass.STANDARD
    if isinstance(value, PriorityClass):
        return value
    if isinstance(value, str):
        try:
            return PriorityClass[value.strip().upper()]
        except KeyError:
            raise ValueError(
                f"unknown priority class {value!r} (choices: "
                f"{[c.name.lower() for c in PriorityClass]})") from None
    if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        try:
            return PriorityClass(int(value))
        except ValueError:
            raise ValueError(
                f"priority class value {int(value)} out of range "
                f"(valid: {[int(c) for c in PriorityClass]})") from None
    raise ValueError(
        f"priority must be a PriorityClass, its name or its int value "
        f"(got {type(value).__name__})")


def normalize_slo_targets(targets) -> dict:
    """Per-class SLO targets as ``{PriorityClass: {"ttft_s", "tok_per_s"}}``.

    Either key may be absent or None (no target on that axis); a
    non-positive target could never be met and is refused, as are
    unknown keys and non-dict targets."""
    out = {}
    for key, tgt in (targets or {}).items():
        cls = coerce_priority(key)
        if tgt is None:
            continue
        if not isinstance(tgt, dict):
            raise ValueError(
                f"SLO target for {cls.name.lower()} must be a dict "
                f"with 'ttft_s'/'tok_per_s' keys (got "
                f"{type(tgt).__name__})")
        unknown = set(tgt) - {"ttft_s", "tok_per_s"}
        if unknown:
            raise ValueError(
                f"unknown SLO target keys {sorted(unknown)} for "
                f"{cls.name.lower()} (valid: ttft_s, tok_per_s)")
        clean = {}
        for k in ("ttft_s", "tok_per_s"):
            v = tgt.get(k)
            if v is None:
                continue
            if float(v) <= 0:
                raise ValueError(
                    f"SLO {k} for class {cls.name.lower()} must be "
                    f"positive (got {v})")
            clean[k] = float(v)
        if clean:
            out[cls] = clean
    return out


def normalize_class_quotas(quotas) -> dict:
    """Validate per-class page-pool quotas into
    ``{PriorityClass: {"floor": f, "cap": f}}``.

    ``quotas`` maps a class (enum / name / int, via
    :func:`coerce_priority`) to ``{"floor": fraction, "cap": fraction}``:

    * ``floor`` *reserves* that fraction of the pool — other classes may
      never allocate into it, so the class always has room to admit
      (the REALTIME working-set guarantee);
    * ``cap`` *bounds* the fraction the class may occupy at admission
      (a soft cap: it blocks new allocations, it never evicts running
      requests when traffic shifts — the BATCH-flood limiter).

    Fractions must lie in (0, 1]: zero is a no-op spelled as a
    guarantee, above one can never be satisfied.  The floors must sum
    to at most 1 (you cannot reserve more than the pool), and a floor
    above the same class's cap is contradictory (the class could never
    fill its own reservation).
    """
    out: dict = {}
    total_floor = 0.0
    for key, quota in (quotas or {}).items():
        cls = coerce_priority(key)
        if quota is None:
            continue
        if not isinstance(quota, dict):
            raise ValueError(
                f"class quota for {cls.name.lower()} must be a dict "
                f"with 'floor'/'cap' keys (got {type(quota).__name__})")
        unknown = set(quota) - {"floor", "cap"}
        if unknown:
            raise ValueError(
                f"unknown class-quota keys {sorted(unknown)} for "
                f"{cls.name.lower()} (valid: floor, cap)")
        if cls in out:
            raise ValueError(
                f"duplicate class quota for {cls.name.lower()} "
                f"(the same class named twice under different spellings)")
        clean = {}
        for k in ("floor", "cap"):
            v = quota.get(k)
            if v is None:
                continue
            v = float(v)
            if not 0.0 < v <= 1.0:
                raise ValueError(
                    f"class-quota {k} for {cls.name.lower()} must lie in "
                    f"(0, 1] (got {v}): 0 is a no-op spelled as a "
                    f"guarantee, above 1 can never be satisfied")
            clean[k] = v
        if ("floor" in clean and "cap" in clean
                and clean["floor"] > clean["cap"]):
            raise ValueError(
                f"class-quota floor {clean['floor']} above cap "
                f"{clean['cap']} for {cls.name.lower()}: the class could "
                f"never fill its own reservation")
        total_floor += clean.get("floor", 0.0)
        if clean:
            out[cls] = clean
    if total_floor > 1.0 + 1e-9:
        raise ValueError(
            f"class-quota floors sum to {total_floor:.3f} > 1: cannot "
            f"reserve more than the whole pool")
    return out


def validate_request(prompt, *, vocab: int, temperature=None, top_k=None,
                     deadline_s=None, priority=None) -> np.ndarray:
    """Admission-time validation; returns the prompt as int32.

    Rejects non-integer token ids, out-of-vocab ids, negative
    ``temperature`` / ``top_k``, non-positive ``deadline_s`` and unknown
    ``priority`` classes.  Each may be a scalar or a ``{slot: v}`` dict,
    whose entries are checked one by one (None entries mean no limit).
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
    for x in each(deadline_s):
        if float(x) <= 0:
            raise ValueError(f"deadline_s must be positive (got {x})")
    for x in each(priority):
        coerce_priority(x)          # unknown/out-of-range classes raise
    return p.astype(np.int32)


def request_row(*, ttft_s: float, gen_tokens: int, decode_s: float,
                status: RequestStatus, priority=None) -> dict:
    """One ``Engine.request_log`` row; ``tok_per_s`` is None (not 0.0)
    when the decode interval is not measurable, and ``priority`` is the
    class name."""
    return {"ttft_s": float(ttft_s), "gen_tokens": int(gen_tokens),
            "decode_s": float(decode_s), "status": status.value,
            "priority": coerce_priority(priority).name.lower(),
            "tok_per_s": (gen_tokens / decode_s) if decode_s > 0 else None}


def now() -> float:
    """Engine wall clock."""
    return time.perf_counter()
