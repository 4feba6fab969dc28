#!/usr/bin/env python3
"""qmatmul on one card: the planned instances against the parent kernel,
and the plan's design choices.

    python3 chip_qmatmul_variants.py [--out build/qmatmul_variants.json]

At every qmatmul case of chip_smoke phase 3 (the same shapes and draws:
seed 1 on the card, in its order) it times, with chip_smoke's ``Timer``
(cold L2, median of 15), each bitwise ``qmatmul_plain`` and each other:

* the instance ``qmatmul_plan`` picks and the parent kernel (the
  control instance, on its own split);
* at M <= 64 (the weight stream), each candidate alone: the split
  doubled (two blocks an SM where they fit) and halved, a two-stage ring
  (fewer bytes in flight);
* at M > 64 (wgmma), one or two boxes, 64 token rows, the split doubled;
  where the plan takes the narrow tile (N and K at most 64), its other
  row count and the 128 x 128 wgmma tile it replaces;
* where the plan takes the control on a TMA-addressable shape, the TMA
  instance it turned down;
* as context only, the fastest of a few plain PyTorch reductions that
  read the weight bytes (M <= 64);
* the planned TMA instance built from a copy of ``csrc/qmatmul.cu`` that
  returns after the products (``noepilogue``: the sums folded into one
  value that is never stored, no staging, no epilogue, no stores; its
  output is wrong and only its time is read): what the loads and
  products alone cost.

It also prints the host time an eager call takes to enqueue each
instance (a TMA instance encodes two tensor maps a call).  One JSON line
a case; then the worst planned / parent ratio; the last line is the
card.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def weight_reads(torch, b):
    """Plain PyTorch calls that read every byte of ``b`` once and write
    almost nothing (context for a bytes-bound kernel)."""
    flat = b.reshape(-1)
    reads = {}
    if flat.numel() % 4 == 0:
        reads["amax_i32"] = lambda: flat.view(torch.int32).amax()
        reads["sum_i32"] = lambda: flat.view(torch.int32).sum(
            dtype=torch.int32)
    if flat.numel() % 8 == 0:
        reads["amax_i64"] = lambda: flat.view(torch.int64).amax()
    return reads


def candidates(qmod, plan, sms):
    """The plans to time beside ``plan`` (each changes one choice; the
    kernel's launcher shortens a ring that does not fit)."""
    m, n, k = plan.m, plan.n, plan.k
    out = {}

    def add(name, p):
        if p != plan and p not in out.values():
            out[name] = p
    if plan.instance == "control" and n % 16 == 0 and k % 16 == 0:
        # the TMA instance the plan turned down (M <= 16, short K)
        inst = "stream" if m <= 64 else "wgmma"
        try:
            add(inst, qmod.qmatmul_plan(m, n, k, sms, inst))
        except ValueError:
            pass
    splits_x2 = dataclasses.replace(
        plan, splits=min(2 * plan.splits, -(-k // qmod.BK)))
    if plan.instance == "stream":
        add("splits_x2", splits_x2)
        add("splits_half", dataclasses.replace(
            plan, splits=max(1, plan.splits // 2)))
        add("stages2", dataclasses.replace(plan, stages=2))
    elif plan.cols == qmod.NARROW:
        for r in qmod.NARROW_ROWS:
            add(f"narrow_rows{r}", dataclasses.replace(plan, rows=r))
        add("wide", dataclasses.replace(plan, cols=qmod.BOX, rows=128,
                                        bk=qmod.BK))
    elif plan.instance == "wgmma":
        add(f"boxes{3 - plan.cols // qmod.BOX}", dataclasses.replace(
            plan, cols=qmod.BOX * (3 - plan.cols // qmod.BOX)))
        add("rows64", dataclasses.replace(plan, rows=64))
        add("splits_x2", splits_x2)
    return out


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds an eager call takes to enqueue (the card runs
    behind it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_qmatmul_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import qmatmul as qmod
    from repro_torch.kernels.qmatmul import (qmatmul, qmatmul_plain,
                                             qmatmul_plan)

    # the copy without the epilogue (under build/, includes made absolute)
    src = _cuda.SOURCES["qmatmul"].read_text()
    cut = "  // out^T -> out through shared memory"
    if src.count(cut) != 1:
        raise RuntimeError(f"'{cut}' not found once in qmatmul.cu")
    vdir = _cuda.BUILD_DIR.parent / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    path = vdir / "qmatmul_noepilogue.cu"
    # the sums are folded into one value that is never written, so that
    # ptxas keeps the products (it drops a product whose result is dead)
    text = src.replace(cut, (
        "  { int fold = 0;\n#pragma unroll\n  for (int T = 0; T < G::kT; ++T)\n"
        "#pragma unroll\n    for (int i = 0; i < ROWS / 2; ++i) fold ^= "
        "acc[T][i];\n  if (fold == 0x12345678) p.tickets[0] = 1u;\n"
        "  return; }\n") + cut)
    for header in ("hopper.cuh", "apply_table.cuh"):
        text = text.replace(f'#include "{header}"',
                            f'#include "{_cuda.CSRC / header}"')
    path.write_text(text)
    _cuda.SOURCES["qmatmul_noepilogue"] = path
    _cuda.SIGNATURES["qmatmul_noepilogue"] = _cuda.SIGNATURES["qmatmul"]
    _cuda.build(["qmatmul", "qmatmul_noepilogue"])
    cs.ptxas_summary(_cuda.BUILD_LOG)
    libs = {"kernel": _cuda.library("qmatmul"),
            "noepilogue": _cuda.library("qmatmul_noepilogue")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = cs.Timer(torch)
    tables = {"gelu": TableSpec("gelu_gate", 1024, -8.0, 8.0, None,
                                "interp"),
              "silu": TableSpec("silu_gate", 1024, -10.0, 10.0, None,
                                "interp")}
    rows, worst = [], (0.0, None)
    g = torch.Generator(device="cuda").manual_seed(1)
    for m, name, k, n, out, table, with_bias in cs.qmatmul_cases():
        # the same draws as chip_smoke's check_qmatmul, in its order
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        sa = (torch.rand((m, 1), generator=g, device="cuda") + 0.1) * 1e-3
        sb = (torch.rand((1, n), generator=g, device="cuda") + 0.1) * 1e-3
        bias = (torch.randn((n,), generator=g, device="cuda")
                if with_bias else None)
        dt = getattr(torch, out)
        spec = tables.get(table)
        kw = dict(act_spec=spec, act_gated=spec is not None)
        plan = qmatmul_plan(m, n, k, sms)
        control = qmatmul_plan(m, n, k, sms, "control")
        plans = {"plan": plan, "parent": control,
                 **candidates(qmod, plan, sms)}
        want = qmatmul_plain(a, b, sa, sb, bias, dt, **kw)
        row = dict(case=f"{name} M={m} K={k} N={n} {out}",
                   plan=cs.qmm_plan_name(plan), bitwise={}, ms={},
                   plans={key: cs.qmm_plan_name(p) for key, p in
                          plans.items()})
        for key, p in plans.items():

            def call(p=p):
                return qmatmul(a, b, sa, sb, bias, dt, plan=p, **kw)
            got = call()
            torch.cuda.synchronize()
            row["bitwise"][key] = cs.same_raw_bits(torch, got, want)
            row["ms"][key] = timer(call)
        if plan.instance != "control":
            _cuda._LIBS["qmatmul"] = libs["noepilogue"]
            row["ms"]["noepilogue"] = timer(
                lambda: qmatmul(a, b, sa, sb, bias, dt, plan=plan, **kw))
            _cuda._LIBS["qmatmul"] = libs["kernel"]
        if m <= 64 and spec is None and b.numel() % 4 == 0:
            row["ms"]["read_weights"] = min(
                timer(fn) for fn in weight_reads(torch, b).values())
        if plan.instance != "control":
            ratio = row["ms"]["plan"] / row["ms"]["parent"]
            worst = max(worst, (ratio, row["case"]))
        rows.append(row)
        print(json.dumps(row), flush=True)
    # host time to enqueue one eager call, by instance (M 8 wq, M 128 wq)
    host = {}
    for m in (8, 128):
        a = torch.randint(-127, 128, (m, 2048), device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (2048, 2048), device="cuda",
                          dtype=torch.int8)
        for inst in (None, "control"):
            p = qmatmul_plan(m, 2048, 2048, sms, inst)
            host[f"M{m} {p.instance}"] = host_us(
                torch, lambda: qmatmul(a, b, 1e-3, 1e-3, plan=p))
    print(json.dumps({"host_us_per_call": host}), flush=True)
    print(json.dumps({"worst_plan_over_parent": worst[0],
                      "case": worst[1]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "host_us_per_call": host,
                       "worst_plan_over_parent": worst, "card": smi}, f,
                      indent=1)
    print(smi)
    return 0 if all(all(r["bitwise"].values()) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
