"""Unified serving autotuner: knob resolution and adaptive ``spec_k``
(port of ``repro.launch.autotune``).

The engine's knob surface -- ``kv_split`` (parallel flash-decoding
partitions per slot), ``pages_per_step`` (KV pages per kernel tile),
``decode_block`` (decode steps per host sync) and ``spec_k`` (drafts per
verify round) -- is resolved as one vector per workload shape at Engine
construction, by minimizing a latency estimator over the knob grid.  The
estimator is linear over one feature basis, with two weight sources:

* **analytic**: the split cost model's hand-set constants
  (``kernels/flash_attention.py``'s ``_ANALYTIC_COST_CONSTANTS``)
  re-expressed as weights, so the resolver reproduces ``_resolve_knobs``'
  auto decision exactly;
* **fitted**: least-squares weights over the same features, fitted on
  the paged-attention kernel's latencies measured on the card by
  ``python -m repro_torch.launch.calibrate`` and kept in the port's own
  artifact, ``AUTOTUNE_H100.json`` (with the card's name and power
  limit).  The reference's ``AUTOTUNE.json`` and ``BENCH_calibrate.json``
  are CPU fits of another backend and are never read here: without the
  port's artifact ``load_estimator("fitted")`` falls back to the analytic
  weights with ``source="analytic-fallback"``.

:class:`SpecKAdapter` re-ranks ``spec_k`` online from the engine's
measured acceptance, with a window, a hysteresis band and a cooldown
(every switch costs one new decode graph on the card).  The block
length changes only the host sync granularity, and the verifier commits
the longest argmax-matching prefix for any k, so neither changes a
greedy stream.  The split knobs change the order in which the kernel
sums attention, within its tolerance.  With int8 weights that changed
greedy streams on the card, under f32 and bf16 compute alike: the
activation quantizer rounds to integer codes, and a difference in the
last f32 bit can move one.  With f32 weights and f32 compute the streams
agreed (ROADMAP.md, queue 3).  ``fitted`` is therefore not a pure speed
choice for an int8 Engine.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..kernels.flash_attention import (_ANALYTIC_COST_CONSTANTS,
                                       get_cost_constants,
                                       set_cost_constants)

__all__ = ["WorkloadShape", "KnobVector", "LatencyEstimator",
           "analytic_estimator", "fit_rows", "feature_vector",
           "kv_candidates", "resolve", "rank_spec_k", "SpecKAdapter",
           "install", "load_estimator", "save_artifact", "load_artifact",
           "ARTIFACT_NAME", "DECODE_BLOCKS", "FEATURES"]

#: repo root (``src/repro_torch/launch/autotune.py``, three parents up),
#: where the port's fitted artifact lives
_REPO_ROOT = Path(__file__).resolve().parents[3]
#: the port's artifact: a fit measured on an H100 (never the reference's)
ARTIFACT_NAME = "AUTOTUNE_H100.json"
#: environment variable naming another artifact path
ARTIFACT_ENV = "REPRO_TORCH_AUTOTUNE"

#: decode-block candidates: powers of two between a per-token host sync
#: and one sync per request (admission and deadlines sweep at block
#: boundaries, so an unbounded block starves the scheduler)
DECODE_BLOCKS = (4, 8, 16, 32)

#: analytic per-block overheads of the decode_block model, in relative
#: units: one host round trip vs one decode step, and a per-step
#: responsiveness penalty of a longer block
_DISPATCH_COST = 8.0
_STEP_COST = 1.0
_SWEEP_COST = 0.25

#: speculative round economics of the k ranker: one drafted token (a
#: device-side gather for prompt lookup) vs one k+1-position verify pass
_DRAFT_COST = 0.07
_VERIFY_COST = 1.0
#: zero-data prior of the per-draft acceptance; ranks k=4 best
_ACCEPT_PRIOR = 0.6

#: feature basis of both estimators (the artifact stores weights in
#: this order)
FEATURES = ("chain", "chain_rows", "split", "lanes", "work", "one")


# ---------------------------------------------------------------------------
# shapes and knob vectors


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    """What the resolver needs to know about a serving geometry.

    ``pages`` is the block-table width (pages per slot) — 0 for a dense
    cache, which skips the kv knobs.  ``gen_len`` is the expected
    generation budget per request (the decode_block amortization term);
    engines that do not know it pass their cache bound as a proxy.
    """

    pages: int
    page_size: int
    hkv: int
    batch: int
    gen_len: int = 64
    spec: bool = False


@dataclasses.dataclass(frozen=True)
class KnobVector:
    """One resolved point on the engine's knob surface."""

    kv_split: int
    pages_per_step: int
    decode_block: int
    spec_k: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# latency estimator: one feature basis, two weight sources


def feature_vector(pages: int, page_size: int, hkv: int, batch: int,
                   kv_split: int, pages_per_step: int) -> np.ndarray:
    """Analytic cost-model features of one knob point (see FEATURES).

    * ``chain``      — serial tile-chain length ``ceil(tiles / split)``
                       (the latency-critical path of the split kernel),
    * ``chain_rows`` — chain × KV rows per tile (DMA/compute volume on
                       that path; separates tall tiles from many tiles),
    * ``split``      — combine count (log-sum-exp merge traffic),
    * ``lanes``      — ``batch * hkv`` parallel grid lanes,
    * ``work``       — chain × split × rows × lanes, the total KV
                       volume the schedule touches.  Nearly constant
                       across the knob grid of ONE shape (splitting
                       re-orders work, it does not add much) but it
                       spans orders of magnitude BETWEEN shapes — it
                       absorbs the cross-shape scale so the chain/split
                       weights are identified by within-shape variation,
                       which is what the resolver actually ranks,
    * ``one``        — intercept (fixed dispatch overhead).
    """
    t = max(1, int(pages_per_step))
    split = max(1, int(kv_split))
    tiles = max(1, -(-max(1, int(pages)) // t))
    chain = -(-tiles // split)
    rows = t * max(1, int(page_size))
    lanes = max(1, int(batch)) * max(1, int(hkv))
    return np.array([chain, chain * rows, split, lanes,
                     chain * split * rows * lanes / 1024.0, 1.0],
                    np.float64)


@dataclasses.dataclass(frozen=True)
class LatencyEstimator:
    """Linear latency model over :func:`feature_vector`.

    ``source`` is provenance ("analytic", "fit", "artifact") — it rides
    into ``Engine.stats()`` so a run always says which model picked its
    knobs.  ``n_rows``/``residual`` describe the fit (0/0 analytic).
    """

    weights: tuple
    source: str = "analytic"
    n_rows: int = 0
    residual: float = 0.0

    def predict(self, pages: int, page_size: int, hkv: int, batch: int,
                kv_split: int, pages_per_step: int) -> float:
        f = feature_vector(pages, page_size, hkv, batch,
                           kv_split, pages_per_step)
        return float(f @ np.asarray(self.weights, np.float64))

    def cost_constants(self) -> dict:
        """Project the weights onto ``choose_kv_split``'s two scalars.

        The legacy ranker charges a flat TILE per serial chain step;
        this model's marginal chain-step cost is ``w_chain +
        w_chain_rows * rows + w_work * rows * lanes / 1024`` — taken at
        the canonical operating point (the 128-row default tile,
        one partition, lanes=4, i.e. the smoke engine's geometry), the
        same point at which the analytic weights round-trip to exactly
        TILE=4.0.  Clamped positive — a degenerate fit (tiny sweep,
        collinear columns) must never flip the ranking's sign.
        """
        w = np.asarray(self.weights, np.float64)
        rows, lanes = 128.0, 4.0
        tile = w[0] + w[1] * rows + w[4] * rows * lanes / 1024.0
        combine = w[2]
        return {"tile_cost": max(1e-6, float(tile)),
                "combine_cost": max(1e-6, float(combine))}

    def to_json(self) -> dict:
        return {"features": list(FEATURES),
                "weights": [float(w) for w in self.weights],
                "source": self.source, "n_rows": int(self.n_rows),
                "residual": float(self.residual),
                "constants": self.cost_constants()}

    @classmethod
    def from_json(cls, d: dict) -> "LatencyEstimator":
        if list(d.get("features", FEATURES)) != list(FEATURES):
            raise ValueError(
                f"estimator feature basis {d.get('features')} does not "
                f"match this build's {list(FEATURES)}; refit with "
                f"repro_torch.launch.calibrate instead of reinterpreting "
                f"weights")
        return cls(weights=tuple(float(w) for w in d["weights"]),
                   source=str(d.get("source", "artifact")),
                   n_rows=int(d.get("n_rows", 0)),
                   residual=float(d.get("residual", 0.0)))


def analytic_estimator() -> LatencyEstimator:
    """The hand-set constants as weights over the fitted basis.

    ``choose_kv_split``'s flat TILE=4.0 is split into a fixed half and
    a per-row half anchored at the 128-row default tile, so tile
    height participates in the ranking (a flat per-tile charge would
    make ever-taller tiles look free) while the cost of the canonical
    tile — and therefore every legacy split decision — is unchanged.
    """
    C = _ANALYTIC_COST_CONSTANTS
    tile, comb = C["tile_cost"], C["combine_cost"]
    return LatencyEstimator(
        weights=(tile / 2.0, tile / 2.0 / 128.0, comb, 0.0, 0.0, 0.0),
        source="analytic")


def _nonneg_lstsq(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with every weight clamped nonnegative.

    Clamp-and-refit active set: solve, drop any feature whose weight
    went negative, re-solve on the survivors.  Converges in at most
    one pass per feature and is deterministic for a given row set.
    Unconstrained lstsq is the wrong tool here: the features are
    collinear across shapes, and a *negative* weight on a work term
    lets the solver trade cross-shape scale against within-shape
    ranking — exactly the ranking the resolver exists to get right
    (a negative chain_rows weight makes LONGER serial chains predict
    cheaper, inverting every split decision).
    """
    idx = list(range(X.shape[1]))
    for _ in range(X.shape[1]):
        sol, *_ = np.linalg.lstsq(X[:, idx], y, rcond=None)
        neg = [i for j, i in enumerate(idx) if sol[j] < 0.0]
        if not neg:
            break
        idx = [i for i in idx if i not in neg]
    w = np.zeros(X.shape[1])
    for j, i in enumerate(idx):
        w[i] = max(0.0, float(sol[j]))
    return w


def fit_rows(rows: Sequence[dict]) -> LatencyEstimator:
    """Least-squares fit of the latency model from measured rows.

    Each row needs the shape/knob fields of :func:`feature_vector` plus
    ``us_per_call`` (the rows ``launch.calibrate`` emits).  rule4ml's
    lesson applies: the model only has to *rank* knob points, so a
    small constrained ``lstsq`` over the sweep rows is enough — no
    regularizer, deterministic for a given row set.  Two constraints
    keep the ranking honest where plain lstsq fails: weights are
    nonnegative (each feature is a unit of schedule work; see
    :func:`_nonneg_lstsq`) and rows are scaled to per-shape relative
    latency (see the inline note).
    """
    rows = [r for r in rows if r.get("us_per_call") is not None]
    if len(rows) < len(FEATURES):
        raise ValueError(
            f"need >= {len(FEATURES)} calibration rows to fit "
            f"{len(FEATURES)} weights (got {len(rows)}); run "
            f"python -m repro_torch.launch.calibrate on the card first")
    X = np.stack([feature_vector(r["pages"], r["page_size"], r["hkv"],
                                 r["batch"], r["kv_split"],
                                 r["pages_per_step"]) for r in rows])
    y = np.asarray([float(r["us_per_call"]) for r in rows], np.float64)
    # per-shape scale weighting: divide each row (features AND target)
    # by the shape's mean latency before solving.  The resolver only
    # ever compares candidates WITHIN one shape, but shapes differ in
    # absolute scale by orders of magnitude — unweighted lstsq spends
    # the whole loss budget on the slowest shape's offset and misranks
    # the fast ones.  Normalizing makes every shape's ranking worth the
    # same loss; the weights keep latency units at the average scale.
    key = lambda r: (r["pages"], r["page_size"], r["hkv"], r["batch"])
    by_shape = {}
    for r in rows:
        by_shape.setdefault(key(r), []).append(float(r["us_per_call"]))
    scale = np.asarray([max(np.mean(by_shape[key(r)]), 1e-12)
                        for r in rows], np.float64)
    Xn, yn = X / scale[:, None], y / scale
    w = _nonneg_lstsq(Xn, yn)
    pred = Xn @ w
    # residual in the normalized space the fit optimizes: 1 - R^2 over
    # relative-latency targets, i.e. how much of the *ranking-relevant*
    # variance the basis explains
    denom = float(np.sum((yn - yn.mean()) ** 2)) or 1.0
    residual = float(np.sum((yn - pred) ** 2) / denom)
    return LatencyEstimator(weights=tuple(float(v) for v in w),
                            source="fit", n_rows=len(rows),
                            residual=residual)


# ---------------------------------------------------------------------------
# artifact plumbing


def _artifact_path(path=None) -> Path:
    if path is not None:
        return Path(path)
    env = os.environ.get(ARTIFACT_ENV)
    return Path(env) if env else _REPO_ROOT / ARTIFACT_NAME


def save_artifact(est: LatencyEstimator, path=None, *,
                  device: Optional[dict] = None,
                  rows: Optional[list] = None) -> Path:
    """Write the fit as JSON: the weights, and ``device`` (the card's
    ``name`` and ``power_limit`` as ``nvidia-smi`` reports them) and the
    measured ``rows`` when given, so the artifact says what it was
    measured on."""
    p = _artifact_path(path)
    d = est.to_json()
    if device is not None:
        d["device"] = dict(device)
    if rows is not None:
        d["rows"] = list(rows)
    p.write_text(json.dumps(d, indent=1, sort_keys=True) + "\n")
    return p


def load_artifact(path=None) -> Optional[LatencyEstimator]:
    """The artifact's estimator (``source="artifact"``), or None."""
    p = _artifact_path(path)
    if not p.exists():
        return None
    est = LatencyEstimator.from_json(json.loads(p.read_text()))
    return dataclasses.replace(est, source="artifact")


def load_estimator(mode: str, path=None) -> LatencyEstimator:
    """The estimator a given ``autotune`` mode runs with.  ``fitted``
    loads the port's artifact, else falls back to the analytic weights
    (``source="analytic-fallback"``); every other mode gets the analytic
    weights."""
    if mode == "fitted":
        est = load_artifact(path)
        if est is not None:
            return est
        return dataclasses.replace(analytic_estimator(),
                                   source="analytic-fallback")
    return analytic_estimator()


def install(est: LatencyEstimator) -> dict:
    """Install the fit into ``choose_kv_split``'s global constants.

    This rewires every *legacy* auto-split decision (direct kernel
    calls, engines running ``autotune="off"``) to the fitted ranking;
    engines in ``analytic``/``fitted`` mode resolve through the
    estimator directly and do not need it.  Returns the constants now
    in effect; ``install(analytic_estimator())`` restores the defaults.
    """
    c = est.cost_constants()
    if est.source == "analytic":
        return set_cost_constants()
    return set_cost_constants(tile_cost=c["tile_cost"],
                              combine_cost=c["combine_cost"])


# ---------------------------------------------------------------------------
# the resolver


def _pow2_upto(n: int) -> List[int]:
    out, v = [], 1
    while v <= n:
        out.append(v)
        v *= 2
    return out


def kv_candidates(shape: WorkloadShape) -> List[tuple]:
    """The (pages_per_step, kv_split) grid the resolver scores.

    Tiles are powers of two up to ~128 KV rows (the cap
    ``auto_pages_per_step`` applies), splits are powers of two up to
    the tile count, subject to the occupancy guard: a split is
    admissible while its *predecessor* leaves lanes unsaturated (the
    boundary candidate is in, exactly as the fixed ``choose_kv_split``
    costs it).  ``target_lanes`` stays the analytic constant: the
    calibration sweep fits the chain and split weights only.
    """
    target = get_cost_constants()["target_lanes"]
    cap = max(1, min(128 // max(1, shape.page_size), shape.pages))
    # tallest tiles first: at equal predicted cost the resolver keeps
    # the first candidate scanned, and the legacy default is the
    # 128-row tile — tie behaviour must match it
    t_grid = sorted(set(_pow2_upto(cap) + [cap]), reverse=True)
    lanes = max(1, shape.batch) * max(1, shape.hkv)
    out = []
    for t in t_grid:
        tiles = -(-shape.pages // t)
        for split in _pow2_upto(tiles):
            out.append((t, split))      # boundary candidate included
            if split > 1 and lanes * (split // 2) >= target:
                break                   # deeper splits: saturated
    return out


def _resolve_kv(shape: WorkloadShape, est: LatencyEstimator) -> tuple:
    best, best_cost = (1, 1), None
    for t, split in kv_candidates(shape):
        cost = est.predict(shape.pages, shape.page_size, shape.hkv,
                           shape.batch, split, t)
        if best_cost is None or cost < best_cost - 1e-12:
            best, best_cost = (t, split), cost
    return best


def _resolve_decode_block(gen_len: int) -> int:
    """Amortize the host↔device round trip against tail waste and
    scheduler granularity: a request generating G tokens pays
    ``ceil(G/n)`` dispatches of ``n`` steps each, plus a per-step
    responsiveness penalty growing with n."""
    g = max(1, int(gen_len))
    best, best_cost = DECODE_BLOCKS[0], None
    for n in DECODE_BLOCKS:
        blocks = -(-g // n)
        cost = (blocks * (_DISPATCH_COST + n * _STEP_COST)
                + n * _SWEEP_COST) / g
        if best_cost is None or cost < best_cost - 1e-12:
            best, best_cost = n, cost
    return min(best, max(1, g))


def rank_spec_k(p: float, k_max: int, *, draft_cost: float = _DRAFT_COST,
                verify_cost: float = _VERIFY_COST) -> int:
    """Best ``spec_k`` for per-draft acceptance probability ``p``.

    A round with k drafts commits ``1 + sum_{i=1..k} p^i`` expected
    tokens (the verifier always advances one token even on total
    rejection) and costs one verify pass plus k draft steps; rank k by
    expected committed tokens per unit cost.  Deterministic argmax with
    ties to the smaller k (fewer wasted drafts at equal throughput).
    """
    p = min(max(float(p), 0.0), 0.999)
    best, best_score = 1, None
    for k in range(1, max(1, int(k_max)) + 1):
        committed = 1.0 + sum(p ** i for i in range(1, k + 1))
        score = committed / (verify_cost + k * draft_cost)
        if best_score is None or score > best_score + 1e-12:
            best, best_score = k, score
    return best


def resolve(shape: WorkloadShape,
            est: Optional[LatencyEstimator] = None) -> KnobVector:
    """Resolve the whole knob vector for one workload shape.

    Deterministic per (shape, estimator weights): the grids are fixed,
    ties break to the first candidate in a sorted scan.  Explicit
    engine kwargs always override individual components — the resolver
    only fills what the caller left on "auto".
    """
    est = est or analytic_estimator()
    if shape.pages > 0:
        t, split = _resolve_kv(shape, est)
    else:
        t = split = 1                    # dense cache: no kv knobs
    return KnobVector(kv_split=split, pages_per_step=t,
                      decode_block=_resolve_decode_block(shape.gen_len),
                      spec_k=rank_spec_k(_ACCEPT_PRIOR, 8))


# ---------------------------------------------------------------------------
# online spec_k adaptation


def _invert_acceptance(a_bar: float, k: int) -> float:
    """Per-draft acceptance p from mean accepted drafts per round.

    ``E[accepted | k drafts] = sum_{i=1..k} p^i`` (a draft is accepted
    iff every draft before it was) — monotone in p, inverted by
    bisection.  Clamped to [0, 0.999]: observing k/k accepted means
    "p as high as this window can measure", not p = 1.
    """
    k = max(1, int(k))
    a_bar = float(a_bar)
    if a_bar <= 0.0:
        return 0.0
    if a_bar >= k - 1e-9:
        return 0.999
    lo, hi = 0.0, 0.999
    for _ in range(40):
        mid = (lo + hi) / 2.0
        if sum(mid ** i for i in range(1, k + 1)) < a_bar:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2.0


class SpecKAdapter:
    """Acceptance-adaptive ``spec_k`` with hysteresis and cooldown.

    The engine feeds it the per-block acceptance telemetry it already
    keeps (``verify_steps``/``draft_accepted`` deltas); ``propose``
    re-ranks k over a sliding window of recent rounds and switches only
    when the projected throughput gain clears the hysteresis band, at
    most once per cooldown — every switch to a new k builds one more
    spec loop (on the card, one more CUDA graph), so the distinct
    proposed k values bound the rebuilds.  ``k_max`` must not exceed the engine's construction-time
    ``spec_k``: the KV margin and drafting history are sized for it.
    """

    def __init__(self, k_init: int, *, k_min: int = 1,
                 k_max: Optional[int] = None, window: int = 64,
                 min_rounds: int = 16, hysteresis: float = 0.10,
                 cooldown: int = 4, draft_cost: float = _DRAFT_COST,
                 verify_cost: float = _VERIFY_COST):
        self.k = max(1, int(k_init))
        self.k_min = max(1, int(k_min))
        self.k_max = max(self.k_min, int(k_max if k_max is not None
                                         else k_init))
        self.window = max(1, int(window))
        self.min_rounds = max(1, int(min_rounds))
        self.hysteresis = float(hysteresis)
        self.cooldown = max(1, int(cooldown))
        self.draft_cost = float(draft_cost)
        self.verify_cost = float(verify_cost)
        #: (rounds, accepted, k) per observed block, newest last
        self._obs: List[tuple] = []
        self._blocks_since_switch = self.cooldown    # free first switch
        self.switches = 0

    def observe(self, rounds: int, accepted: int) -> None:
        """Record one decode block's verify telemetry (deltas, not
        cumulative counters)."""
        if rounds > 0:
            self._obs.append((int(rounds), int(accepted), self.k))
            total = sum(r for r, _, _ in self._obs)
            while self._obs and total - self._obs[0][0] >= self.window:
                total -= self._obs[0][0]
                self._obs.pop(0)
        self._blocks_since_switch += 1

    def acceptance(self) -> Optional[float]:
        """Windowed per-draft acceptance probability (None = no data)."""
        rounds = sum(r for r, _, _ in self._obs)
        if rounds < self.min_rounds:
            return None
        # rounds may span different k values right after a switch;
        # invert each segment at its own k and round-weight the result
        num = den = 0.0
        for r, a, k in self._obs:
            num += r * _invert_acceptance(a / r, k)
            den += r
        return num / den

    def _score(self, k: int, p: float) -> float:
        committed = 1.0 + sum(p ** i for i in range(1, k + 1))
        return committed / (self.verify_cost + k * self.draft_cost)

    def propose(self) -> int:
        """Current best k (== current k unless a switch is warranted)."""
        p = self.acceptance()
        if p is None or self._blocks_since_switch < self.cooldown:
            return self.k
        best = self.k
        best_score = self._score(self.k, p)
        for k in range(self.k_min, self.k_max + 1):
            s = self._score(k, p)
            if s > best_score * (1.0 + self.hysteresis):
                best, best_score = k, s
        if best != self.k:
            self.k = best
            self.switches += 1
            self._blocks_since_switch = 0
        return self.k
