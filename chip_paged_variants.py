#!/usr/bin/env python3
"""Paged attention on one card: the Hopper kernel's plan against the
control, and the plan's design choices.

    python3 chip_paged_variants.py [--out build/paged_variants.json]

At every paged case of chip_smoke phase 3 (the same shapes and draws:
seed 2 on the card, in its order; bf16 queries), at the knob points
``(1, 1)`` and the reference's auto knobs, it times with chip_smoke's
``Timer`` (cold L2, median of 15) each of these, after holding its
output to chip_smoke's bf16 gate against the plain version:

* the Hopper kernel on ``paged_call_plan``'s plan, and the control (the
  first port's kernel) on the same call;
* rows a block: fewer than the plan's (2, 4, 8 or 16 rows, more row
  tiles);
* a decode-like call's (S <= 8) fewest entries a block: 1, 2 or 3
  (``PAGED_DECODE_MIN_PER``), with the decode groups;
* the in-partition split: 1, 2, 4 or 8 blocks a partition, or one entry
  a block (with as many groups as the block's entries allow);
* the groups of warps walking a block's pages at once: 1, 2, 4 or 8;
* the ring: one, two or three pages a group;
* the plan on ``csrc/paged_attention.cu`` built apart with
  ``PAGED_LOADS_ONLY`` defined, whose blocks stage every page and skip
  the products (``loads_only``: the ring, the bulk copies, the partials
  and the merge; its output is wrong and only its time is read): what
  the page stream alone costs.

The products run in f32 on the CUDA cores in every variant: the kernel
has no tensor-core form to time against them (PERF.md section 7).  One
JSON line a case; then the worst planned / control ratio and each
case's fastest variant; the last line is the card.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def candidates(plan, fa, s):
    """The plans to time beside ``plan`` (a call of ``s`` positions a
    lane), each changing one choice (and none the kernel's launcher
    refuses)."""
    out = {}

    def add(name, p):
        if p != plan and p not in out.values() and p.fits():
            out[name] = p
    if s <= fa.PAGED_DECODE_S:      # the decode-like floor, as the plan
        for per in range(1, min(3, plan.span) + 1):
            g = min(per, fa.PAGED_DECODE_GROUPS)
            p = dataclasses.replace(plan, per=per, groups=g, rw=min(
                plan.rw, (fa.PAGED_MAX_WARPS - 1) // g))
            add(f"per{per}", dataclasses.replace(
                p, stages=fa.paged_stages(p.ring, per, g)))
    for rw in (1, 2, 4, 8):
        if rw < plan.rw and 1 + plan.groups * rw <= fa.PAGED_MAX_WARPS:
            add(f"rows{2 * rw}", dataclasses.replace(plan, rw=rw))
    for cpp in (1, 2, 4, 8, plan.span):
        per = -(-plan.span // min(cpp, plan.span))
        groups = max(1, min((fa.PAGED_MAX_WARPS - 1) // plan.rw, per,
                            plan.ring))
        p = dataclasses.replace(plan, per=per, groups=groups,
                                stages=fa.paged_stages(plan.ring, per, groups))
        while not p.fits() and p.groups > 1:
            p = dataclasses.replace(
                p, groups=p.groups - 1,
                stages=fa.paged_stages(plan.ring, per, p.groups - 1))
        add(f"cpp{p.cpp}", p)
    for groups in (1, 2, 4, 8):
        g = min(groups, plan.per, plan.ring)
        if 1 + g * plan.rw <= fa.PAGED_MAX_WARPS:
            add(f"groups{g}", dataclasses.replace(
                plan, groups=g, stages=fa.paged_stages(plan.ring, plan.per,
                                                       g)))
    for k in (1, 2, 3):             # stages: a multiple of the groups
        add(f"stages{k * plan.groups}",
            dataclasses.replace(plan, stages=k * plan.groups))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write every row as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_paged_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import (paged_attention_ref,
                                         paged_attention_split_ref)

    # the kernel's source with PAGED_LOADS_ONLY defined, as a library of
    # its own (under build/; the source's digest in the file, so that an
    # edit of the kernel rebuilds it)
    src = _cuda.SOURCES["paged_attention"]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    vdir = _cuda.BUILD_DIR.parent / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    path = vdir / "paged_loads_only.cu"
    path.write_text(f"// {src.name} {digest}\n#define PAGED_LOADS_ONLY\n"
                    f'#include "{src}"\n')
    _cuda.SOURCES["paged_loads_only"] = path
    _cuda.SIGNATURES["paged_loads_only"] = _cuda.SIGNATURES[
        "paged_attention"]
    _cuda.build(["paged_attention", "paged_loads_only"])
    cs.ptxas_summary(_cuda.BUILD_LOG)
    loads_only = _cuda.library("paged_loads_only")

    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2)
    rows, worst, failed = [], (0.0, None), []
    for label, b, s, tokens, dead, width_tokens, heads in \
            cs.attention_cases():
        hq, hkv, d = heads
        for q_dtype in (torch.bfloat16, torch.float32):
            # the same draws as check_attention, in its order
            q, kp, vp, bt, qpos = cs._attention_case(
                torch, g, b, s, tokens, dead, width_tokens, q_dtype, heads)
            if q_dtype != torch.bfloat16:
                continue
            np_ = bt.shape[1]
            auto = fa._resolve_knobs(np_, 16, hkv, b, None, None)
            for t, split in dict.fromkeys(((1, 1), auto)):
                plan = fa.paged_call_plan(q, kp, vp, bt, kv_split=split,
                                          pages_per_step=t)
                ctl = fa.paged_call_plan(q, kp, vp, bt, kv_split=split,
                                         pages_per_step=t,
                                         instance="control")
                plans = {"plan": plan, "control": ctl,
                         **candidates(plan, fa, s)}
                what = ("paged_attention_unsplit" if (t, split) == (1, 1)
                        else "paged_attention_split")

                def launch(p, lib=None):
                    return fa._launch_paged(q, kp, vp, bt, qpos, None, what,
                                            split, t, p, lib=lib)
                want = (paged_attention_ref(q, kp, vp, bt, qpos)
                        if (t, split) == (1, 1) else
                        paged_attention_split_ref(q, kp, vp, bt, qpos,
                                                  kv_split=split,
                                                  pages_per_step=t))
                row = dict(case=f"{label} B={b} S={s} tokens~{tokens} "
                           f"table={np_} heads={hq}/{hkv} D={d} "
                           f"knobs=(t={t},split={split})",
                           plan=cs.paged_plan_name(plan), ms={}, err={},
                           plans={k: cs.paged_plan_name(p)
                                  for k, p in plans.items()})
                for key, p in plans.items():
                    try:
                        got = launch(p)
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        row["err"][key] = f"refused: {e}"
                        continue
                    err = (got.float() - want.float()).abs().max().item()
                    row["err"][key] = err
                    if not torch.allclose(got.float(), want.float(),
                                          atol=2.0 ** -6, rtol=2.0 ** -8):
                        failed.append((row["case"], key, err))
                    row["ms"][key] = timer(lambda: launch(p))
                row["ms"]["loads_only"] = timer(
                    lambda: launch(plan, loads_only))
                ratio = row["ms"]["plan"] / row["ms"]["control"]
                worst = max(worst, (ratio, row["case"]))
                fastest = min(row["ms"], key=lambda k: (
                    row["ms"][k] if k != "loads_only" else float("inf")))
                row["fastest"] = fastest
                rows.append(row)
                print(json.dumps(row), flush=True)
    print(json.dumps({"worst_plan_over_control": worst[0],
                      "case": worst[1]}), flush=True)
    for r in rows:
        print(f"{r['case']}: plan {r['ms']['plan'] * 1e3:.1f} us, control "
              f"{r['ms']['control'] * 1e3:.1f} us, loads only "
              f"{r['ms']['loads_only'] * 1e3:.1f} us, fastest {r['fastest']} "
              f"{r['ms'][r['fastest']] * 1e3:.1f} us", flush=True)
    if failed:
        print(json.dumps({"over_the_gate": failed}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "worst_plan_over_control": worst,
                       "over_the_gate": failed, "card": smi}, f, indent=1)
    print(smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
