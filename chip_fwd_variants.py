#!/usr/bin/env python3
"""The flash forward's TMA kernel: design choices measured on one card.

    python3 chip_fwd_variants.py [--out build/fwd_variants.json]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and
variants of it, each a copy (under ``build/variants/``) with one line
edited:

* ``overlap128``: at D 128 too, S of tile t goes in flight beside P.V of
  tile t - 1 (the instance then spills);
* ``nooverlap64``: at D 64 neither does; S_t is issued after P.V_{t-1}
  has been joined;
* ``terms2``: P.V multiplies two of p's three bf16 terms (hi and lo).
  Its output is wrong, and only its time is read: what the third term
  costs.

At every bf16 entry of chip_smoke's FLASH_CASES that the TMA kernel
takes (the same inputs as chip_smoke phase 3: seed 4 on the card, on the
grid ``flash_fwd_plan`` picks) each prints the device time (cold L2,
median of 15, chip_smoke's Timer), whether the output passes chip_smoke's
bf16 gate against ``flash_attention_plain``, and whether it is bitwise the
kernel's as built.  One JSON line a case; the last line is the card.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

VARIANTS = {
    "overlap128": ("constexpr bool OVERLAP = DP == 64 && NWG < 3;",
                   "constexpr bool OVERLAP = DP <= 128 && NWG < 3;"),
    "nooverlap64": ("constexpr bool OVERLAP = DP == 64 && NWG < 3;",
                    "constexpr bool OVERLAP = false;"),
    "terms2": ("      wgmma_m64n64k16_rs_t(acc, mi[kk], b, 1);\n", ""),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa

    src = _cuda.SOURCES["flash_attention"].read_text()
    vdir = _cuda.BUILD_DIR.parent / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    names = {"kernel": "flash_attention"}
    for key, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant {key}: '{old}' not found once")
        path = vdir / f"flash_attention_{key}.cu"
        path.write_text(src.replace(old, new).replace(
            '#include "hopper.cuh"',
            f'#include "{_cuda.CSRC / "hopper.cuh"}"'))
        names[key] = f"flash_attention_{key}"
        _cuda.SOURCES[names[key]] = path
        _cuda.SIGNATURES[names[key]] = _cuda.SIGNATURES["flash_attention"]
    _cuda.build(list(names.values()))
    for key, name in names.items():
        spill = [ln.strip() for ln in _cuda.BUILD_LOG[name]["ptxas"]
                 if "bytes spill" in ln and not ln.strip().startswith("0 ")]
        print(f"[build] {key}: spill lines {spill}", flush=True)
    libs = {key: _cuda.library(name) for key, name in names.items()}
    timer = cs.Timer(torch)
    rows = []
    g = torch.Generator(device="cuda").manual_seed(4)
    for (label, b, hq, hkv, sq, skv, d, causal, dtypes,
         dv) in cs.FLASH_CASES:
        for dname in dtypes:
            # the same draws as chip_smoke's check_flash, in its order
            dt = torch.bfloat16 if dname == "bf16" else torch.float32
            q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(dt)
            k = torch.randn((b, hkv, skv, d), generator=g,
                            device="cuda").to(dt)
            v = torch.randn((b, hkv, skv, d), generator=g,
                            device="cuda").to(dt)
            if dv is not None:
                v[..., dv:] = 0
            if dt != torch.bfloat16 or d % 8:
                continue
            plan = fa.flash_fwd_plan(b, hq, hkv, sq, skv, d,
                                     causal=causal,
                                     sms=_cuda.sm_count(q.device))
            want = fa.flash_attention_plain(q, k, v, causal=causal).float()
            ulp = torch.exp2(torch.floor(torch.log2(
                want.abs().clamp_min(2.0 ** -126))) - 7)
            row = dict(case=label, grid=cs.grid_name(plan), ms={},
                       gate={}, bitwise={})
            base = None
            for key, lib in libs.items():

                def launch():
                    out = torch.empty_like(q)
                    err = lib.flash_attention_launch(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), None, b, hq, hkv, sq, skv, d,
                        d ** -0.5, int(causal), 1, plan.wgs,
                        int(plan.pack_heads), _cuda.stream_of(q))
                    _cuda.check(lib, err, key)
                    return out
                out = launch()
                torch.cuda.synchronize()
                base = out if base is None else base
                row["gate"][key] = bool(((out.float() - want).abs()
                                         <= ulp + 2e-5).all().item())
                row["bitwise"][key] = cs.same_raw_bits(torch, out, base)
                row["ms"][key] = timer(launch)
            rows.append(row)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "card": smi}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
