"""Knob-grid calibration of the autotuner on the card (the port's
counterpart of the reference's ``benchmarks/bench_calibrate.py``).

For a few paged-attention geometries it walks the admissible
``(pages_per_step, kv_split)`` grid of :func:`~repro_torch.launch.
autotune.kv_candidates`, times the CUDA paged-attention kernel at each
point (device time with CUDA events, the median of cold-L2 launches: a
256 MB write flushes the L2 and a spin kernel hides the host's enqueue),
fits the autotuner's feature basis with :func:`~repro_torch.launch.
autotune.fit_rows` and writes the port's artifact, ``AUTOTUNE_H100.json``,
with the card's name and power limit and every measured row.  Engines
built with ``autotune="fitted"`` load it.

It refuses to run without a card: a CPU timing is not a fit of the
kernel.  The gates are the reference's: the fit explains the sweep
(residual, 1 - R^2, below 0.5) and the point it ranks best in each shape
measures within 2x of the measured best.

    python -m repro_torch.launch.calibrate [--out AUTOTUNE_H100.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from typing import List, Optional

import torch

from ..core.device import resolve_device
from ..kernels.flash_attention import paged_attention
from .autotune import (WorkloadShape, _artifact_path, fit_rows,
                       kv_candidates, save_artifact)

__all__ = ["SHAPES", "sweep", "fit_and_gate", "device_info", "main"]

#: (pages, page_size, hq, hkv, batch, d): the reference sweep's three
#: geometries (long-chain MQA, grouped KV, a short chain), then gemma-2b's
#: decode (8 query heads on 1 KV head of 256, 16-row pages) at the
#: serving table of 12 pages, at ~1024 and ~4096 tokens, and at batch 32
SHAPES = (
    (64, 8, 4, 1, 4, 64),
    (32, 8, 4, 2, 2, 64),
    (16, 16, 4, 1, 8, 64),
    (12, 16, 8, 1, 8, 256),
    (64, 16, 8, 1, 8, 256),
    (257, 16, 8, 1, 8, 256),
    (64, 16, 8, 1, 32, 256),
)


class _Timer:
    """Device ms of one call with a cold L2 (median of ``reps``)."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _inputs(pages, ps, hq, hkv, batch, d, device, seed):
    """A decode step's inputs: every lane's table a permutation of the
    pool's pages, the query at the last row (all of the table visible)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((batch, hq, 1, d), generator=g, device=device)
    kp = torch.randn((pages + 1, hkv, ps, d), generator=g, device=device)
    vp = torch.randn((pages + 1, hkv, ps, d), generator=g, device=device)
    bt = torch.stack([torch.randperm(pages, generator=g, device=device)
                      for _ in range(batch)]).to(torch.int32)
    qpos = torch.full((batch,), pages * ps - 1, dtype=torch.int32,
                      device=device)
    return q, kp, vp, bt, qpos


def _require_card(device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(
            f"calibration times the CUDA paged-attention kernel and needs "
            f"a card (got device {device}); a CPU timing is not a fit of "
            f"the kernel")
    return device


def sweep(shapes=SHAPES, *, reps: int = 15, device=None) -> List[dict]:
    """One row per admissible grid point of each shape: the shape and
    knob key and ``us_per_call`` (kernel device time)."""
    device = _require_card(device)
    timer = _Timer(device)
    rows = []
    for i, (pages, ps, hq, hkv, batch, d) in enumerate(shapes):
        q, kp, vp, bt, qpos = _inputs(pages, ps, hq, hkv, batch, d, device,
                                      seed=i)
        shape = WorkloadShape(pages=pages, page_size=ps, hkv=hkv,
                              batch=batch)
        for t, split in kv_candidates(shape):
            ms = timer(lambda: paged_attention(q, kp, vp, bt, qpos,
                                               kv_split=split,
                                               pages_per_step=t), reps)
            rows.append({"bench": "calibrate",
                         "name": f"p{pages}ps{ps}b{batch}h{hkv}q{hq}d{d}"
                                 f"_t{t}s{split}",
                         "pages": pages, "page_size": ps, "hkv": hkv,
                         "hq": hq, "d": d, "batch": batch,
                         "kv_split": split, "pages_per_step": t,
                         "us_per_call": ms * 1e3})
    return rows


def fit_and_gate(rows: List[dict]):
    """``(estimator, gates)``: the fit of ``rows`` and the reference's
    two gates, ``residual`` (< 0.5) and ``ranking_ratio`` (<= 2.0, the
    measured time of the fit's best point over the measured best, worst
    shape)."""
    est = fit_rows(rows)
    worst = 0.0
    keys = sorted({(r["pages"], r["page_size"], r["hkv"], r["batch"])
                   for r in rows})
    for key in keys:
        pts = [r for r in rows
               if (r["pages"], r["page_size"], r["hkv"], r["batch"]) == key]
        best = min(p["us_per_call"] for p in pts)
        pick = min(pts, key=lambda p: est.predict(
            p["pages"], p["page_size"], p["hkv"], p["batch"],
            p["kv_split"], p["pages_per_step"]))
        worst = max(worst, pick["us_per_call"] / best)
    gates = {"residual": est.residual, "ranking_ratio": worst,
             "ok": est.residual < 0.5 and worst <= 2.0}
    return est, gates


def device_info(device=None) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    device = _require_card(device)
    info = {"name": torch.cuda.get_device_name(device), "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            name, limit = out.stdout.strip().split(",", 1)
            info.update(name=name.strip(), power_limit=limit.strip())
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Fit the autotuner's estimator from the card's "
                    "paged-attention kernel times.")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: AUTOTUNE_H100.json at the "
                         "repo root)")
    args = ap.parse_args(argv)
    device = _require_card(None)
    rows = sweep(device=device)
    est, gates = fit_and_gate(rows)
    for r in rows:
        print(f"{r['name']}: {r['us_per_call']:.2f} us")
    info = device_info(device)
    print(json.dumps({"device": info, "gates": gates,
                      "fit": est.to_json()}))
    if not gates["ok"]:
        raise SystemExit(f"calibration fit failed its gates: {gates}")
    path = save_artifact(est, _artifact_path(args.out), device=info,
                         rows=rows)
    print(f"wrote {path}")
    return {"rows": rows, "estimator": est, "gates": gates, "path": path}


if __name__ == "__main__":
    main()
