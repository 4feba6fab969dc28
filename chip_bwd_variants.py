#!/usr/bin/env python3
"""The flash backward's numerical design choices, measured on one card.

    python3 chip_bwd_variants.py [--out chiprun_out/bwd_variants.json]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` as it is
and variants of it, each a copy (under ``build/variants/``) with one
constant edited:

* ``terms2``: p and ds enter their tensor-core products as two bf16 terms
  (16 bits), not three (all 24);
* ``nofresh``: dk, dv and dq accumulate across steps in the tensor cores'
  own accumulators, which truncate, instead of a fresh accumulator a
  step joined with round-to-nearest.

At every bf16 entry of chip_smoke's FLASH_BWD_CASES (the same inputs as
chip_smoke phase 3: seed 5 on the card) each prints the relative L2 of dq,
dk and dv against ``flash_attention_bwd_plain`` beside chip_smoke's bf16
gate, whether two launches give the same bits, and the device time (cold
L2, median of 15, chip_smoke's Timer).  The gemma cases are also timed at
other items a dk/dv block (``--per``) than the split plan picks.  One JSON
line a case; the last line is the card.  Needs one CUDA card.

``--yardstick`` builds nothing and times only chip_smoke's library
yardstick for these rows, SDPA's backward (``autograd.grad`` through
``scaled_dot_product_attention``), at every case and type of
FLASH_BWD_CASES, five ways in one run: chip_smoke's ``Timer``; the same
loop with a 1M-cycle spin after a read flush, and after a write flush
(a 256 MB ``zero_``, which leaves dirty lines); a 20M-cycle spin after a
read flush; and the backward captured in a CUDA graph, its replay timed
by ``Timer``.  Beside them, the host time a warm call takes to enqueue.
A reading that moves with the spin is host-bound; one that moves with
the flush is the flush's.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

VARIANTS = {
    "terms2": ("constexpr int TERMS = 3;", "constexpr int TERMS = 2;"),
    "nofresh": ("constexpr bool FRESH_ACC = true;",
                "constexpr bool FRESH_ACC = false;"),
}


def spin_timed(torch, fn, flush, write: bool, spin: int,
               reps: int = 15) -> float:
    """chip_smoke's ``Timer`` loop with the flush and the spin given."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if write:
            flush.zero_()
        else:
            flush.amax()
        torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def yardstick(torch, cs) -> list:
    """SDPA's backward at every FLASH_BWD_CASES entry (chip_smoke phase
    3's draws: seed 5 on the card, in its order), timed five ways."""
    import torch.nn.functional as F
    timer = cs.Timer(torch)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    rows = []
    g = torch.Generator(device="cuda").manual_seed(5)
    for (label, b, hq, hkv, sq, skv, d, causal, dtypes,
         dvw) in cs.FLASH_BWD_CASES:
        for dname in dtypes:
            dt = torch.bfloat16 if dname == "bf16" else torch.float32

            def rnd(*shape):
                return torch.randn(shape, generator=g, device="cuda").to(dt)
            q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv,
                                                                   skv, d)
            do = rnd(b, hq, sq, d)
            if dvw is not None:
                v[..., dvw:] = 0
                do[..., dvw:] = 0
            fn = cs._sdpa_backward(torch, F, q, k, v, do, causal)
            row = dict(case=f"{label} {dname}")
            try:
                fn()
            except RuntimeError as e:
                row["refused"] = str(e).splitlines()[0]
                print(json.dumps(row), flush=True)
                rows.append(row)
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            row["host_ms"] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            row["timer_ms"] = timer(fn)
            row["read_spin1M_ms"] = spin_timed(torch, fn, flush, False,
                                               1_000_000)
            row["write_spin1M_ms"] = spin_timed(torch, fn, flush, True,
                                                1_000_000)
            row["read_spin20M_ms"] = spin_timed(torch, fn, flush, False,
                                                20_000_000)
            try:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    gfn = cs._sdpa_backward(torch, F, q, k, v, do, causal)
                    gfn()
                    gfn()
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    gfn()
                row["graph_ms"] = timer(graph.replay)
                del graph, gfn
            except RuntimeError as e:
                row["graph_ms"] = None
                row["graph_refused"] = str(e).splitlines()[0]
            print(json.dumps(row), flush=True)
            rows.append(row)
            del q, k, v, do, fn
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--per", default="6,8,11,16,22",
                    help="items a dk/dv block to time the gemma cases at")
    ap.add_argument("--yardstick", action="store_true",
                    help="time only SDPA's backward, five ways")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.yardstick:
        rows = yardstick(torch, cs)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(dict(card=smi, rows=rows), f, indent=1)
        print(smi)
        return 0
    src = _cuda.SOURCES["flash_attention_bwd"].read_text()
    vdir = _cuda.BUILD_DIR.parent / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    names = {"kernel": "flash_attention_bwd"}
    for key, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant {key}: '{old}' not found once")
        path = vdir / f"flash_attention_bwd_{key}.cu"
        path.write_text(src.replace(old, new))
        names[key] = f"flash_attention_bwd_{key}"
        _cuda.SOURCES[names[key]] = path
        _cuda.SIGNATURES[names[key]] = _cuda.SIGNATURES["flash_attention_bwd"]
    _cuda.build(["flash_attention", *names.values()])
    libs = {key: _cuda.library(name) for key, name in names.items()}
    timer = cs.Timer(torch)
    pers = [int(x) for x in args.per.split(",") if x]
    rows = []
    g = torch.Generator(device="cuda").manual_seed(5)
    for (label, b, hq, hkv, sq, skv, d, causal, dtypes,
         dvw) in cs.FLASH_BWD_CASES:
        for dname in dtypes:
            # the same draws as chip_smoke's check_flash_bwd, in its order
            dt = torch.bfloat16 if dname == "bf16" else torch.float32

            def rnd(*shape):
                return torch.randn(shape, generator=g, device="cuda").to(dt)
            q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv,
                                                                   skv, d)
            do = rnd(b, hq, sq, d)
            if dname != "bf16":
                continue
            if dvw is not None:
                v[..., dvw:] = 0
                do[..., dvw:] = 0
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                            with_lse=True)
            want = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal)
            row = dict(case=label, gate=cs.FLASH_BWD_TOL["bf16"])

            def run():
                return fa.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=causal)
            for key, lib in libs.items():
                _cuda._LIBS["flash_attention_bwd"] = lib
                got, again = run(), run()
                torch.cuda.synchronize()
                row[key] = dict(
                    rel_l2_dq_dk_dv=[cs.rel_l2(torch, x, y)
                                     for x, y in zip(got, want)],
                    bitwise=all(cs.same_raw_bits(torch, x, y)
                                for x, y in zip(got, again)),
                    ms=timer(run))
            _cuda._LIBS["flash_attention_bwd"] = libs["kernel"]
            if label.startswith("h gemma"):
                plan = fa.flash_bwd_plan(b, hq, hkv, sq, skv, d,
                                         causal=causal, bf16=True,
                                         sms=_cuda.sm_count(q.device))
                row["plan_per"] = plan.per
                real = fa.flash_bwd_plan
                try:
                    for per in pers:
                        forced = fa.FlashBwdPlan(
                            b, hq, hkv, sq, skv, d, bool(causal),
                            plan.kv_rows, plan.chunks, per)
                        fa.flash_bwd_plan = (
                            lambda *a, forced=forced, **kw: forced)
                        row[f"per{per}"] = dict(blocks=forced.blocks,
                                                ms=timer(run))
                finally:
                    fa.flash_bwd_plan = real
            print(json.dumps(row), flush=True)
            rows.append(row)
            del q, k, v, do, o, lse, want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, rows=rows), f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
