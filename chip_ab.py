#!/usr/bin/env python3
"""Decode steps and whisper's int8 encoder of one tree of the port, on one
NVIDIA GPU, for a same-card comparison of two trees.

    python3 chip_ab.py --src SRC_DIR --label NAME [--json OUT]
                       [--graphs off|on|both]

Imports ``repro_torch`` from ``SRC_DIR`` (a tree's ``src`` directory),
builds its kernels, and measures, with random weights from a seed:

* gemma-2b at full width, bf16 compute, batch 8, prompt 128, the paths
  of ``chip_smoke.py`` -- 1: int8 weights, paged f32 KV at the auto
  knobs; 3: int8 weights with the tables and int8 KV rows on the dense
  cache; 4: bf16 weights, ``--lut --paged`` -- each with all 8 lanes
  live: one warm 8-step decode block on the host clock (wall per step),
  then one under ``torch.profiler`` (the second of two: device busy per
  step, device kernels and copies per step, and the device time and
  launches of the paged-attention kernels, ``paged_*``, per step);
  ``--graphs`` runs each path's Engine with ``graphs=False``, ``True``
  or both in turn (off, on); without it the tree's default applies (a
  tree from before CUDA-graph dispatch takes no ``graphs`` argument);
* whisper-base, int8 weights, batch 8, 1500 encoder frames: the
  encoder's device time (CUDA events, median of 5 warm calls) and its
  device kernels and copies under the profiler.

It prints one JSON line.  Two trees are compared by running this script
for each in turns (A, B, B, A) in one command on one card: wall times
move with the host, so only differences within one command count.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def device_rows(prof):
    """(kernel, device ms, count) of a torch.profiler run."""
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0)
        if dev and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((ev.key, dev / 1e3, ev.count))
    return rows


def profiled(torch, fn, part=None):
    """(wall ms, device busy ms, device kernels and copies) of ``fn`` under
    torch.profiler, the second of two traced runs (the first starts the
    tracer); with ``part`` (a substring of kernel names) also the device
    ms and launches of the kernels whose names hold it."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    out = (wall * 1e3, sum(r[1] for r in rows), sum(r[2] for r in rows))
    if part is None:
        return out
    mine = [r for r in rows if part in r[0]]
    return out + (sum(r[1] for r in mine), sum(r[2] for r in mine))


def gemma_paths(torch, out, graphs=None):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import Engine, quantize_for_serving
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext

    cfg = get_config("gemma-2b")
    int8 = QuantContext(mode="int8",
                        policy=PrecisionPolicy.uniform(FixedPointType(8, 4)),
                        compute_dtype=torch.bfloat16)
    lutf = QuantContext(mode="none", use_lut=True,
                        compute_dtype=torch.bfloat16)
    batch, plen, gen, block = 8, 128, 64, 8
    src = SyntheticLM(cfg.vocab, seed=0)
    prompts = [src.tokens(i, 1, plen)[0, :-1] for i in range(batch)]
    max_len = plen + gen + 1
    geometry = dict(batch=batch, max_len=max_len, prefill_chunk=16,
                    page_size=16, device="cuda")
    pages = 2 * batch * -(-max_len // 16)     # room for every lane at once
    q8 = quantize_for_serving(
        lm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                device="cuda"), int8)
    paths = [("1 int8 paged, auto", int8, q8,
              dict(paged=True, num_pages=pages)),
             ("3 int8 --lut --kv-bits 8, dense",
              dataclasses.replace(int8, use_lut=True), q8, dict(kv_bits=8)),
             ("4 --lut --paged, bf16", lutf, None,
              dict(paged=True, num_pages=pages))]
    arms = {None: [{}], "off": [{"graphs": False}], "on": [{"graphs": True}],
            "both": [{"graphs": False}, {"graphs": True}]}[graphs]
    for label, ctx, params, kw in paths:
        if params is None:
            del q8
            params = lm.init(torch.Generator(device="cuda").manual_seed(0),
                             cfg, dtype=torch.bfloat16, device="cuda")
        for arm in arms:
            name = label + "".join(f", graphs {'on' if v else 'off'}"
                                   for v in arm.values())
            eng = Engine(cfg, ctx, params, **geometry, **kw, **arm)
            for p in prompts:
                eng.submit(p, gen_len=gen)
            eng.try_admit()
            eng.step_many(block)              # warm (graphs: + capture)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step_many(block)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            _, busy, launches, paged, paged_n = profiled(
                torch, lambda: eng.step_many(block), part="paged_")
            if not eng.live.all():
                raise AssertionError(f"{name}: a lane finished inside the "
                                     f"measured blocks")
            out[name] = dict(wall_ms_per_step=wall / block,
                             device_busy_ms_per_step=busy / block,
                             device_launches_per_step=launches / block,
                             paged_ms_per_step=paged / block,
                             paged_launches_per_step=paged_n / block)
            log(f"[ab] {name}: wall {wall / block:.3f} ms/step, device "
                f"busy {busy / block:.3f} ms/step, {launches / block:.1f} "
                f"device kernels and copies per step; paged attention "
                f"{paged / block:.3f} ms/step in {paged_n / block:.1f} "
                f"launches")
            del eng
    torch.cuda.empty_cache()


def whisper_encode(torch, out):
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.serve import prepare_params, quantize_for_serving
    from repro_torch.models import encdec
    from repro_torch.nn.context import QuantContext

    cfg = get_config("whisper-base")
    ctx = QuantContext(mode="int8",
                       policy=PrecisionPolicy.uniform(FixedPointType(8, 4)),
                       compute_dtype=torch.bfloat16)
    params = prepare_params(quantize_for_serving(
        encdec.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                    device="cuda"), ctx), ctx, "cuda")
    frames = torch.from_numpy(make_batch(cfg, 0, 8, 1500,
                                         seed=0)["enc_input"]).cuda()

    def encode():
        return encdec.encode(params, frames, cfg, ctx)

    encode()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        encode()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    _, busy, launches = profiled(torch, encode)
    out["whisper int8 encode"] = dict(encode_ms=statistics.median(times),
                                      device_busy_ms=busy,
                                      device_launches=launches)
    log(f"[ab] whisper int8 encode: {statistics.median(times):.3f} ms (CUDA "
        f"events), {launches} device kernels and copies")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--label", required=True)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also append the result line to this file")
    ap.add_argument("--graphs", choices=["off", "on", "both"], default=None,
                    help="decode blocks eager, as CUDA graphs, or both in "
                         "turn (default: the tree's own default)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out = {"label": args.label, "src": args.src, "card": smi}
    log(f"[ab] {args.label} ({args.src}) on {smi}")
    gemma_paths(torch, out, args.graphs)
    whisper_encode(torch, out)
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
