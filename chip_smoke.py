#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py             # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels   # phases 1-3 only: build and check
    python3 chip_smoke.py --profile   # also trace one decode block
    python3 chip_smoke.py --report out.json   # also write every number

Phases, one line each, any failure raises and the exit code is non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and print ``ptxas`` usage, with
   a summary of the tensor-core flash, paged (both routes), tensor-core
   qmatmul, table and quantizer instances;
2. print the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
3. hold every kernel against its plain PyTorch version on the card at the
   main path's shapes (gemma-2b at full width: qmatmul at M = 8 and 128
   over every projection and at a verify pass's M = 40, over
   whisper-base's at M = 8, 128 and 12000 with and without a bias, and
   over the jet MLP's four layers at M = 1, 128 and 16384, all bitwise;
   paged attention at decode, verify (S = 5) and prefill, unsplit
   and split, plus a ~4096-token decode, lut_activation on one layer's
   gate activations at decode and prefill with every indexing and the
   gelu, silu and softmax-exp tables; lut_gated_mul (the gated MLP's
   table pass) on the same shapes, bitwise, beside the unfused chain it
   replaces; quantize_rows at gemma-2b's decode and prefill rows and
   whisper-base's 12000 encoder rows, bitwise with zero, half-way and NaN
   rows; flash_attention at the whisper
   encoder's shape, gemma-2b's cache-free prefill, ragged Sq/Skv and the
   MLA width, bf16 and f32), with the kernel's, the plain version's and a
   library call's device time (median of cold-L2 launches, CUDA events)
   and the kernel/library factor beside the least time the card could
   take; then sampling (PyTorch ops, no kernel of the port) at (8,
   256000): bitwise its plain version on the card, threefry bits bitwise
   the CPU's, its device time from a CUDA graph replay and its device
   kernels per call; likewise ``verify_tokens_fused`` (speculative
   decoding's acceptance rule) at (8, 5, 256000);
4. serve full-width gemma-2b, bf16 compute, batch 8, prompt 128, gen 32,
   on four paths, each with the launch counters reset just before it and
   read just after, failing if a kernel of the path never launched:
   int8 weights on the paged f32 KV cache (16 requests at the auto knobs,
   then 8 at ``kv_split=1``); ``--lut --paged`` with bf16 weights (every
   gated GELU and its product with up through the lut_gated_mul kernel,
   18 launches per model call, lut_activation none); ``--quant int8 --lut
   --kv-bits 8`` on the dense cache (the fused table epilogue, int8 KV
   rows, the table softmax); every int8 path launches one quantize_rows
   per qmatmul.  Every decode block runs as a CUDA graph replay (one
   graph per block length and greedy/sampled, launch counts added per
   replay).  The sampled path: int8 paged, half the lanes at
   temperature 0.8 and top_k 40, served eagerly and graphed (identical
   streams and counts), and graphed in blocks of 2 + 3 and of 5
   (identical streams).  The graphs A/B: paths 1, 3 and 4 with graphs
   off and on, in turns, on the same prompts: identical streams and
   counts, wall per step (three pairs) and device busy per step of both
   (path 1 also graphed with every lane sampled).  Logits of one
   prefill chunk and 4 decode steps through the kernels are compared with
   the plain versions' on the int8 paged and the LUT paged configurations;
   then path 5: full-width whisper-base through the serving step builders
   (batch 8, 1500 encoder frames, prompt 16, 32 greedy tokens in blocks
   of 8, the f32 dense cache), with bf16 and with int8 weights: the
   encoder runs the flash kernel, 6 launches per prefill, checked (and
   int8 one quantize_rows per qmatmul), and
   the logits are held against the plain versions' at path 5's own gates,
   which two planted faults (a causal encoder, zeroed cross K/V) must
   fail.  Path 6: path 1's configuration with speculative decoding
   (spec_k 4, graphed) on tiled prompts: the n-gram drafter, the target
   as its own draft model (its dense draft cache attends through another
   path than the paged target), a drafter that proposes the n-gram run's
   committed streams (the target's own chain: the full-acceptance path),
   the self-drafter on the dense target cache (its streams against the
   plain dense run's logged, not gated: ROADMAP.md queue 3), and the
   n-gram drafter with half the lanes sampled; greedy streams held
   against the plain Engine on the same prompts (identical, or parting
   only where the plain Engine's own top-2 margin is below 1e-3),
   graphed == eager, blocks of 2 + 3 rounds == 5, the chain drafter
   accepting >= 3 of 4 drafts a round; accepted drafts, committed tokens
   per verify pass, wall per committed token and device busy per round
   logged.  Path 7: the jet-tagging MLP at batch 1 and 16384, f32, int8
   PTQ and int8 with the table softmax, the int8 outputs bitwise the
   plain versions', eager and graphed time per batch beside its bound;
5. print the kernels line, then the device line last.

Weights are random (seeded ``torch.Generator`` on the card), quantized by
the port's own ``ptq_params``; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s,
#: int8 tensor-core ops/s, f32 (CUDA-core) flop/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOP_PER_S = 67e12

GEMMA_PROJ = [("wq", 2048, 2048), ("wk/wv", 2048, 256), ("wo", 2048, 2048),
              ("up/gate", 2048, 16384), ("down", 16384, 2048)]
#: whisper-base's projections (d_model 512, d_ff 2048): the decoder runs
#: them at M = 8 (decode) and 128 (the prefill's prompt), the encoder and
#: the cross K/V at M = 8 x 1500 frames
WHISPER_PROJ = [("wq/wk/wv/wo", 512, 512), ("up", 512, 2048),
                ("down", 2048, 512)]
#: the jet-tagging MLP's layers (16 -> 64 -> 32 -> 32 -> 5), run at batch
#: 1, 128 and 16384 (path 7)
JET_PROJ = [("fc0", 16, 64), ("fc1", 64, 32), ("fc2", 32, 32),
            ("fc3", 32, 5)]
#: speculative decoding's draft depth on path 6: a verify pass runs the
#: model at M = 8 x (SPEC_K + 1) = 40 rows and paged attention at S = 5
SPEC_K = 4


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Device time of one call with a cold L2: a 256 MB write flushes the
    50 MB L2, a spin kernel keeps the card busy while the host enqueues
    the call (so host overhead is not timed), CUDA events bracket it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 15) -> float:
        torch = self.torch
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


def fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}ms"


def over_library(row) -> str:
    """``kernel / library`` of a check row, as a factor (n/a: no library
    call); stored in the row as ``kernel_over_library``."""
    lib = row.get("library_ms")
    row["kernel_over_library"] = None if not lib else row["ms"] / lib
    return ("n/a" if row["kernel_over_library"] is None
            else f"{row['kernel_over_library']:.2f}x")


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_qmatmul(torch, timer, rows):
    from repro_torch.core.tables import TableSpec, get_table
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    g = torch.Generator(device="cuda").manual_seed(1)
    # (M, name, K, N, output type, epilogue table, bias)
    cases = [(m, name, k, n, torch.bfloat16, None, False)
             for m in (8, 128) for name, k, n in GEMMA_PROJ]
    cases.append((128, "wq f32", 2048, 2048, torch.float32, None, False))
    # the fused epilogue: bias + gated gelu table (step 2^-6), and silu's
    # gate table, whose step 20/1024 is not a power of two (both the
    # kernel and its plain version index with (y - lo) * step_inv)
    cases.append((128, "up+bias+lut", 2048, 2048, torch.float32,
                  TableSpec("gelu_gate", 1024, -8.0, 8.0, None, "interp"),
                  True))
    cases.append((8, "up+bias+silu-lut", 2048, 16384, torch.bfloat16,
                  TableSpec("silu_gate", 1024, -10.0, 10.0, None,
                            "interp"), True))
    # whisper-base's projections, without and with a bias (the epilogue's
    # fma(acc * sa, sb, bias))
    cases += [(m, f"whisper {name}{'+bias' if bias else ''}", k, n,
               torch.bfloat16, None, bias)
              for m in (8, 128, 12000) for name, k, n in WHISPER_PROJ
              for bias in (False, True)]
    # a speculative verify pass (path 6): 8 lanes x (k + 1) rows
    cases += [(8 * (SPEC_K + 1), f"verify {name}", k, n, torch.bfloat16,
               None, False) for name, k, n in GEMMA_PROJ]
    # the jet MLP's layers (path 7), f32 out with the bias epilogue
    cases += [(m, f"jet {name}", k, n, torch.float32, None, True)
              for m in (1, 128, 16384) for name, k, n in JET_PROJ]
    for m, name, k, n, out_dtype, spec, with_bias in cases:
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        sa = (torch.rand((m, 1), generator=g, device="cuda") + 0.1) * 1e-3
        sb = (torch.rand((1, n), generator=g, device="cuda") + 0.1) * 1e-3
        bias = (torch.randn((n,), generator=g, device="cuda")
                if with_bias else None)
        kw = dict(act_spec=spec, act_gated=spec is not None)
        got = qmatmul(a, b, sa, sb, bias, out_dtype, **kw)
        want = qmatmul_plain(a, b, sa, sb, bias, out_dtype, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # exact int32 accumulation and the same single-rounded epilogue
        # operations in the same order: bitwise equal
        tol = 0.0
        if not (err <= tol and torch.isfinite(got).all().item()):
            raise AssertionError(f"qmatmul {name} M={m}: max_abs_err {err} "
                                 f"> tol {tol}")
        ms = timer(lambda: qmatmul(a, b, sa, sb, bias, out_dtype, **kw))
        plain_ms = timer(lambda: qmatmul_plain(a, b, sa, sb, bias, out_dtype,
                                               **kw), reps=5)
        lib_ms = ctx_ms = read_ms = None
        if n % 8:
            pass                  # torch._int_mm needs N a multiple of 8
        elif m > 16 and spec is None:     # torch._int_mm needs M > 16
            lib_ms = yardstick(timer, lambda: torch._int_mm(a, b))
        elif spec is None:
            # context, not library columns (other functions): _int_mm on A
            # zero-padded to 32 rows, what a library call gets from the
            # same weight stream, and a PyTorch reduction that only reads
            # the weights (their bytes under this timer's cold L2)
            a32 = torch.zeros((32, k), dtype=torch.int8, device="cuda")
            a32[:m] = a
            ctx_ms = yardstick(timer, lambda: torch._int_mm(a32, b))
            b32 = b.view(torch.int32)
            read_ms = timer(lambda: b32.amax())
        out_bytes = 2 if out_dtype == torch.bfloat16 else 4
        nbytes = m * k + k * n + 4 * m + 4 * n + out_bytes * m * n
        if with_bias:
            nbytes += 4 * n
        if spec is not None:
            nbytes += 4 * get_table(spec).np_values.size
        bnd, by = bound_ms(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
        rows.append(dict(kernel="qmatmul", case=f"{name} M={m} K={k} N={n} "
                         f"{str(out_dtype)[6:]}", max_abs_err=err, tol=tol,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         int_mm_m32_ms=ctx_ms, read_weights_ms=read_ms,
                         bound_ms=bnd, bound_by=by))
        log(f"[check] qmatmul {rows[-1]['case']}: max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
            f"library={fmt_ms(lib_ms)} "
            f"kernel/library={over_library(rows[-1])} "
            + (f"(context: _int_mm on A padded to M 32 {ctx_ms:.4f}ms, "
               f"amax reading B {read_ms:.4f}ms) "
               if ctx_ms is not None else "")
            + f"bound={bnd:.4f}ms ({by})")


def check_lut(torch, timer, rows):
    """lut_activation against its plain version on one layer's gate
    activations, (tokens, d_ff) = (8, 16384) at decode and (128, 16384)
    for a prefill chunk, in bf16 and f32, with every indexing, for the
    gated GELU table (the main path's), silu's gate table (a step that is
    not a power of two) and the softmax's AC_FIXED_18_8 exp table."""
    import torch.nn.functional as F
    from repro_torch.core.qtypes import AC_FIXED_18_8
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels.lut_activation import (lut_activation,
                                                    lut_activation_plain)
    g = torch.Generator(device="cuda").manual_seed(3)
    tables = [("gelu_gate", -8.0, 8.0, None), ("silu_gate", -10.0, 10.0, None),
              ("exp", -16.0, 0.0, AC_FIXED_18_8)]
    for fn, lo, hi, qt in tables:
        for indexing in ("trunc", "nearest", "interp"):
            spec = TableSpec(fn, 1024, lo, hi, qt, indexing)
            for m in (8, 128):
                for dt in (torch.bfloat16, torch.float32):
                    x = torch.randn((m, 16384), generator=g, device="cuda")
                    # exp's inputs are the softmax's x - max, in [-16, 0]
                    x = (-x.abs() * 6 if fn == "exp" else x * 4).to(dt)
                    got = lut_activation(x, spec)
                    want = lut_activation_plain(x, spec)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    # the same single-rounded operations, then one rounding
                    # to the output type: bitwise in f32 and bf16
                    tol = 0.0
                    if not (torch.equal(got, want)
                            and torch.isfinite(got).all().item()):
                        raise AssertionError(
                            f"lut_activation {fn} {indexing} {m}x16384 {dt}: "
                            f"max_abs_err {err} > tol {tol}")
                    ms = timer(lambda: lut_activation(x, spec))
                    plain_ms = timer(lambda: lut_activation_plain(x, spec),
                                     reps=5)
                    gelu_ms = timer(lambda: F.gelu(x, approximate="tanh"))
                    nbytes = 2 * x.numel() * x.element_size() + 4 * spec.n
                    # a gather or two and ~10 f32 operations per element
                    bnd, by = bound_ms(nbytes, 10.0 * x.numel(),
                                       F32_FLOP_PER_S)
                    rows.append(dict(
                        kernel="lut_activation",
                        case=f"{fn} {indexing} {m}x16384 {str(dt)[6:]}",
                        max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                        library_ms=None, gelu_tanh_ms=gelu_ms, bound_ms=bnd,
                        bound_by=by))
                    log(f"[check] lut_activation {rows[-1]['case']}: "
                        f"max_abs_err={err:.3g} (tol {tol:.3g}) "
                        f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                        f"library=none kernel/library={over_library(rows[-1])}"
                        f" (context: F.gelu tanh "
                        f"{gelu_ms:.4f}ms) bound={bnd:.5f}ms ({by})")


def check_lut_gated(torch, timer, rows):
    """lut_gated_mul (the gated MLP's table pass) against its plain
    version on one layer's gate and up activations, (tokens, d_ff) = (8,
    16384) at decode and (128, 16384) for a prefill chunk, bf16 and f32,
    every indexing, the gated GELU table (the main path's) and silu's gate
    table (a step that is not a power of two): bitwise.  Context beside
    the kernel: the unfused chain it replaces on the card (the
    lut_activation kernel, then the two PyTorch products), timed alike."""
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels.lut_activation import (lut_activation,
                                                    lut_gated_mul,
                                                    lut_gated_mul_plain)
    g = torch.Generator(device="cuda").manual_seed(5)
    for fn, lo, hi in (("gelu_gate", -8.0, 8.0), ("silu_gate", -10.0, 10.0)):
        for indexing in ("trunc", "nearest", "interp"):
            spec = TableSpec(fn, 1024, lo, hi, None, indexing)
            for m in (8, 128):
                for dt in (torch.bfloat16, torch.float32):
                    x = (torch.randn((m, 16384), generator=g, device="cuda")
                         * 4).to(dt)
                    up = (torch.randn((m, 16384), generator=g,
                                      device="cuda") * 2).to(dt)
                    got = lut_gated_mul(x, up, spec)
                    want = lut_gated_mul_plain(x, up, spec)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    # the same single-rounded operations in the same order
                    tol = 0.0
                    if not (torch.equal(got, want)
                            and torch.isfinite(got).all().item()):
                        raise AssertionError(
                            f"lut_gated_mul {fn} {indexing} {m}x16384 {dt}: "
                            f"max_abs_err {err}, not bitwise")
                    ms = timer(lambda: lut_gated_mul(x, up, spec))
                    plain_ms = timer(lambda: lut_gated_mul_plain(x, up, spec),
                                     reps=5)
                    unfused_ms = timer(
                        lambda: (x * lut_activation(x, spec)).to(dt) * up)
                    nbytes = 3 * x.numel() * x.element_size() + 4 * spec.n
                    # a gather or two and ~12 f32 operations per element
                    bnd, by = bound_ms(nbytes, 12.0 * x.numel(),
                                       F32_FLOP_PER_S)
                    rows.append(dict(
                        kernel="lut_gated_mul",
                        case=f"{fn} {indexing} {m}x16384 {str(dt)[6:]}",
                        max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                        library_ms=None, unfused_chain_ms=unfused_ms,
                        bound_ms=bnd, bound_by=by))
                    log(f"[check] lut_gated_mul {rows[-1]['case']}: "
                        f"bitwise (max_abs_err={err:.3g}) kernel={ms:.4f}ms "
                        f"plain={plain_ms:.4f}ms library=none "
                        f"kernel/library={over_library(rows[-1])} (context: "
                        f"unfused chain lut_activation + 2 products "
                        f"{unfused_ms:.4f}ms) bound={bnd:.5f}ms ({by})")


def same_bits(torch, a, b) -> bool:
    """f32 tensors equal bit for bit, NaN where the other has NaN (its
    payload aside)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32),
                                b[~nan].view(torch.int32)))


#: quantize_rows' cases: gemma-2b's decode rows (K 2048 for wq/wk/wv/up/
#: gate, 16384 for down), a 128-row prefill chunk, whisper-base's encoder
#: (8 x 1500 rows, K 512 and 2048)
QUANT_CASES = [(8, 2048), (8, 16384), (128, 2048), (128, 16384),
               (12000, 512), (12000, 2048)]


def check_quantize_rows(torch, timer, rows):
    """quantize_rows against its plain version (the eager chain the card
    ran before: cast, abs, amax, clamp, divide, round, clamp, cast):
    bitwise, bf16 at every case and f32 at decode, with a zero row, a row
    of half-way values and a NaN row planted.  Context beside the kernel:
    ``torch.amax(x.abs(), 1)``, a PyTorch reduction that reads the same
    bytes (not the same function: no library call quantizes)."""
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.kernels.quantize_rows import (quantize_rows,
                                                   quantize_rows_plain)
    qt = FixedPointType(8, 4)
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [(m, k, torch.bfloat16) for m, k in QUANT_CASES]
    cases += [(8, 2048, torch.float32), (8, 16384, torch.float32)]
    for m, k, dt in cases:
        x = torch.randn((m, k), generator=g, device="cuda") * 3
        x[0] = 0.0
        x[1] = torch.randint(-126, 126, (k,), generator=g,
                             device="cuda").float() + 0.5
        x[1, 0] = 127.0                       # scale 1: x / s lands on k + 0.5
        x[2, k // 3] = float("nan")
        x = x.to(dt)
        q, sc = quantize_rows(x, qt)
        wq, ws = quantize_rows_plain(x, qt)
        torch.cuda.synchronize()
        if not (torch.equal(q, wq) and same_bits(torch, sc, ws)):
            bad = (q != wq).sum().item()
            raise AssertionError(f"quantize_rows {m}x{k} {dt}: {bad} int8 "
                                 f"values differ from the plain version")
        ms = timer(lambda: quantize_rows(x, qt))
        plain_ms = timer(lambda: quantize_rows_plain(x, qt), reps=5)
        read_ms = timer(lambda: torch.amax(x.abs(), 1))
        nbytes = m * k * x.element_size() + m * k + 4 * m
        # |x|, max, one division, round, clamp per element
        bnd, by = bound_ms(nbytes, 6.0 * m * k, F32_FLOP_PER_S)
        rows.append(dict(kernel="quantize_rows",
                         case=f"{m}x{k} {str(dt)[6:]}", max_abs_err=0.0,
                         tol=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                         amax_abs_ms=read_ms, bound_ms=bnd, bound_by=by))
        log(f"[check] quantize_rows {rows[-1]['case']}: bitwise (zero, "
            f"half-way and NaN rows) kernel={ms:.4f}ms plain={plain_ms:.4f}ms"
            f" library=none kernel/library={over_library(rows[-1])} "
            f"(context: torch.amax(x.abs(), 1) {read_ms:.4f}ms) "
            f"bound={bnd:.5f}ms ({by})")


def _attention_case(torch, g, b, s, tokens, dead_lane, width_tokens,
                    q_dtype):
    """Engine-shaped paged attention inputs: gemma-2b heads (8 q, 1 kv,
    D 256), 16-row pages, distinct pages per lane, the trash page last,
    qpos so that each lane's last query sees ``tokens`` positions."""
    hq, hkv, d, ps = 8, 1, 256, 16
    width = -(-width_tokens // ps)
    need = -(-tokens // ps)
    num_pages = b * need
    pages_k = torch.randn((num_pages + 1, hkv, ps, d), generator=g,
                          device="cuda")
    pages_v = torch.randn((num_pages + 1, hkv, ps, d), generator=g,
                          device="cuda")
    perm = torch.randperm(num_pages, generator=g, device="cuda")
    bt = torch.full((b, width), num_pages, dtype=torch.int32, device="cuda")
    bt[:, :need] = perm.reshape(b, need).to(torch.int32)
    qpos = torch.full((b,), tokens - s, dtype=torch.int32, device="cuda")
    qpos -= torch.arange(b, dtype=torch.int32, device="cuda") % 4
    if dead_lane:                     # engine convention: all trash, pos 0
        bt[-1] = num_pages
        qpos[-1] = 0
    q = torch.randn((b, hq, s, d), generator=g, device="cuda").to(q_dtype)
    return q, pages_k, pages_v, bt, qpos


def check_attention(torch, timer, rows):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_resolve_knobs,
                                                     paged_attention_split,
                                                     paged_attention_unsplit)
    from repro_torch.kernels.ref import (paged_attention_ref,
                                         paged_attention_split_ref)
    g = torch.Generator(device="cuda").manual_seed(2)
    # engine geometry: max_len 161 (prompt 128 + gen 32 + 1), prefill
    # chunk 16 of margin -> a 12-page table; the long case ~4096 tokens
    cases = [("decode", 8, 1, 150, True, 177), ("prefill", 8, 16, 128, False,
                                                177),
             ("verify", 8, SPEC_K + 1, 150, True, 177),
             ("decode-4096", 8, 1, 4096, False, 4096 + 16)]
    for label, b, s, tokens, dead, width_tokens in cases:
        for q_dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, bt, qpos = _attention_case(torch, g, b, s, tokens, dead,
                                                  width_tokens, q_dtype)
            np_ = bt.shape[1]
            auto = _resolve_knobs(np_, 16, 1, b, None, None)
            for t, split in ((1, 1), auto):
                if (t, split) == (1, 1):
                    name = "paged_attention_unsplit"

                    def kern():
                        return paged_attention_unsplit(q, kp, vp, bt, qpos)

                    def plain():
                        return paged_attention_ref(q, kp, vp, bt, qpos)
                else:
                    name = "paged_attention_split"

                    def kern():
                        return paged_attention_split(
                            q, kp, vp, bt, qpos, kv_split=split,
                            pages_per_step=t)

                    def plain():
                        return paged_attention_split_ref(
                            q, kp, vp, bt, qpos, kv_split=split,
                            pages_per_step=t)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if q_dtype == torch.bfloat16:
                    # one bf16 ulp at |x| in [2, 4) + relative slack:
                    # both round the same f32 value, summed in another order
                    atol, rtol = 2.0 ** -6, 2.0 ** -8
                else:
                    atol = rtol = 2e-5     # the reference kernel suite's
                ok = torch.allclose(got.float(), want.float(), atol=atol,
                                    rtol=rtol)
                if not (ok and torch.isfinite(got).all().item()):
                    raise AssertionError(f"{name} {label} {q_dtype}: "
                                         f"max_abs_err {err}")
                row = dict(kernel=name, case=f"{label} B={b} S={s} "
                           f"tokens~{tokens} table={np_} knobs=(t={t},"
                           f"split={split}) q={str(q_dtype)[6:]}",
                           max_abs_err=err, tol=[atol, rtol])
                if q_dtype == torch.bfloat16:
                    row["ms"] = timer(kern)
                    row["plain_ms"] = timer(plain, reps=5)
                    row["library_ms"] = _sdpa_ms(torch, F, timer, q, kp, vp,
                                                 bt, qpos)
                    vis = (torch.clamp(qpos + s, max=np_ * 16)
                           .sum().item())           # visible kv rows
                    rows_q = 8 * s
                    nbytes = (q.numel() * 2 * 2 + 2 * vis * 256 * 4
                              + bt.numel() * 4 + b * 4)
                    ops = 4.0 * rows_q * vis * 256
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        nbytes, ops, F32_FLOP_PER_S)
                rows.append(row)
                log(f"[check] {name} {row['case']}: max_abs_err={err:.3g} "
                    f"(atol {atol:.3g}, rtol {rtol:.3g})"
                    + (f" kernel={row['ms']:.4f}ms "
                       f"plain={row['plain_ms']:.4f}ms "
                       f"library={fmt_ms(row['library_ms'])} "
                       f"kernel/library={over_library(row)} "
                       f"bound={row['bound_ms']:.4f}ms ({row['bound_by']})"
                       if "ms" in row else ""))


#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12

#: the flash kernel's cases: (label, B, Hq, Hkv, Sq, Skv, D, causal, dtypes,
#: V's nonzero width); (a) the whisper encoder, (b) gemma-2b's cache-free
#: prefill, (c) ragged and MLA-wide shapes; f32 for (a) and (b) is (d)
FLASH_CASES = [
    ("a whisper-encoder", 8, 8, 8, 1500, 1500, 64, False, ("bf16", "f32"),
     None),
    ("b gemma-prefill", 2, 8, 1, 512, 512, 256, True, ("bf16", "f32"), None),
    ("c ragged Sq<Skv causal", 2, 8, 2, 77, 200, 64, True, ("bf16",), None),
    ("c ragged Sq>Skv", 2, 8, 2, 200, 77, 64, False, ("bf16",), None),
    ("c MLA-width", 1, 16, 16, 256, 256, 192, True, ("bf16",), 128),
]


def check_flash(torch, timer, rows):
    """The flash kernel against its plain version (same inputs, on the
    card), with SDPA's time as the library yardstick (never called by
    the port).  bf16 (the tensor-core kernel, whose three bf16 terms of
    p carry the plain version's f32 p): one bf16 ulp of the output plus
    2e-5 (the f32 sums run in another order); f32 (the CUDA-core kernel):
    atol = rtol = 2e-5."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(4)
    for (label, b, hq, hkv, sq, skv, d, causal, dtypes,
         dv) in FLASH_CASES:
        for dname in dtypes:
            dt = torch.bfloat16 if dname == "bf16" else torch.float32
            q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(dt)
            k = torch.randn((b, hkv, skv, d), generator=g,
                            device="cuda").to(dt)
            v = torch.randn((b, hkv, skv, d), generator=g,
                            device="cuda").to(dt)
            if dv is not None:        # MLA: V zero-padded to the qk width
                v[..., dv:] = 0
            got = flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            gf, wf = got.float(), want.float()
            err = (gf - wf).abs().max().item()
            if dt == torch.bfloat16:
                ulp = torch.exp2(torch.floor(torch.log2(
                    wf.abs().clamp_min(2.0 ** -126))) - 7)
                ok = bool(((gf - wf).abs() <= ulp + 2e-5).all().item())
                tol = "1 bf16 ulp + 2e-5"
            else:
                ok = torch.allclose(gf, wf, atol=2e-5, rtol=2e-5)
                tol = "atol=rtol=2e-5"
            if not (ok and torch.isfinite(got).all().item()):
                raise AssertionError(f"flash_attention {label} {dname}: "
                                     f"max_abs_err {err} beyond {tol}")
            ms = timer(lambda: flash_attention(q, k, v, causal=causal))
            plain_ms = timer(lambda: flash_attention_plain(
                q, k, v, causal=causal), reps=5)
            lib_ms = yardstick(timer, _sdpa_dense(torch, F, q, k, v, causal))
            # visible (query, key) pairs of this run: all, or causal
            # (queries the last Sq positions), counted exactly
            if causal:
                qpos = torch.arange(sq) + (skv - sq)
                pairs = int(torch.clamp(qpos + 1, 0, skv).sum())
            else:
                pairs = sq * skv
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            bnd, by = bound_ms(nbytes, 4.0 * b * hq * pairs * d,
                               BF16_FLOP_PER_S if dt == torch.bfloat16
                               else F32_FLOP_PER_S)
            rows.append(dict(kernel="flash_attention",
                             case=f"{label} B={b} H={hq}/{hkv} Sq={sq} "
                             f"Skv={skv} D={d} causal={causal} {dname}",
                             max_abs_err=err, tol=tol, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bnd, bound_by=by))
            log(f"[check] flash_attention {rows[-1]['case']}: "
                f"max_abs_err={err:.3g} ({tol}) kernel={ms:.4f}ms "
                f"plain={plain_ms:.4f}ms "
                f"library(SDPA)={fmt_ms(lib_ms)} "
                f"kernel/library={over_library(rows[-1])} "
                f"bound={bnd:.4f}ms ({by})")


def check_sampling(torch, timer, report):
    """``sample_tokens_fused`` (the ``cuda`` lowering of
    ``ops.sample_tokens``: PyTorch ops, no kernel of the port, as the
    reference leaves sampling to XLA) at the decode block's shape, (8,
    256000) f32 logits, half the slots at temperature 0.8 and top_k 40:
    bitwise ``sample_tokens_ref`` on the card, its threefry bits bitwise
    the CPU's; its device time (cold L2) beside the greedy argmax, the
    plain version's, and the device kernels one call issues."""
    from repro_torch.kernels import prng
    from repro_torch.kernels.ref import sample_tokens_ref
    from repro_torch.kernels.sampling import sample_tokens_fused
    b, v = 8, 256000
    g = torch.Generator(device="cuda").manual_seed(5)
    logits = torch.randn((b, v), generator=g, device="cuda") * 3
    temp = torch.tensor([t for t, _ in SAMPLING], device="cuda")
    top_k = torch.tensor([k for _, k in SAMPLING], dtype=torch.int32,
                         device="cuda")
    key = prng.fold_in(prng.PRNGKey(SAMPLE_SEED, "cuda"),
                       torch.tensor(3, dtype=torch.int32, device="cuda"))
    host_key = prng.fold_in(prng.PRNGKey(SAMPLE_SEED), 3)
    got = sample_tokens_fused(logits, temp, top_k, key)
    want = sample_tokens_ref(logits, temp, top_k, key)
    bits_equal = torch.equal(prng.random_bits(key, (b, v)).cpu(),
                             prng.random_bits(host_key, (b, v)))
    if not (torch.equal(got, want) and bits_equal
            and torch.equal(key.cpu(), host_key)):
        raise AssertionError(f"sample_tokens_fused {got.tolist()} vs ref "
                             f"{want.tolist()}; threefry bits equal to the "
                             f"CPU's: {bits_equal}")
    # its ~200 small kernels take longer to enqueue than the timer's spin
    # covers: the device time is a graph replay's, and the busy time the
    # profiler's sum of its kernels
    graphs = {}
    for name, fn in (("sampled", lambda: sample_tokens_fused(
            logits, temp, top_k, key)),
            ("greedy", lambda: sample_tokens_fused(logits, temp, top_k)),
            ("noise", lambda: prng.gumbel(key, (b, v))),
            ("plain", lambda: sample_tokens_ref(logits, temp, top_k, key))):
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            out = fn()
        if name == "sampled":
            graphs[name].replay()
            if not torch.equal(out, want):
                raise AssertionError("sample_tokens_fused replayed from a "
                                     "CUDA graph draws other tokens")
    ms = {name: timer(g.replay) for name, g in graphs.items()}
    eager_ms = timer(lambda: sample_tokens_fused(logits, temp, top_k, key))
    busy, kernels = _profiled_busy(
        torch, lambda: sample_tokens_fused(logits, temp, top_k, key))
    del graphs
    # least bytes: read the logits once, write B ids
    bound, by = bound_ms(4 * b * v + 4 * b, 0, F32_FLOP_PER_S)
    row = dict(shape=f"{b}x{v} f32", ms=ms["sampled"],
               plain_ms=ms["plain"], greedy_argmax_ms=ms["greedy"],
               gumbel_noise_ms=ms["noise"], eager_ms=eager_ms,
               device_busy_ms=busy, device_kernels=kernels, bound_ms=bound,
               bound_by=by, library_ms=None, tokens=got.tolist())
    report["sampling"] = row
    log(f"[sampling] sample_tokens_fused {b}x{v} f32 (half the slots at "
        f"0.8 / top_k 40): bitwise the plain version on the card and from "
        f"a CUDA graph, threefry bits bitwise the CPU's; graph replay "
        f"{fmt_ms(ms['sampled'])} (device busy {fmt_ms(busy)}, {kernels} "
        f"device kernels and copies; the noise alone {fmt_ms(ms['noise'])},"
        f" greedy argmax alone {fmt_ms(ms['greedy'])}), eager "
        f"{fmt_ms(eager_ms)}, plain {fmt_ms(ms['plain'])}, bound "
        f"{fmt_ms(bound)} ({by}); no library call samples")


def check_verify(torch, timer, report):
    """``verify_tokens_fused`` (the ``cuda`` lowering of
    ``ops.verify_tokens``: PyTorch ops, as the reference leaves it to XLA)
    at a verify pass's shape, (8, SPEC_K + 1, 256000) f32 logits, half the
    slots at temperature 0.8 and top_k 40, drafts that follow each row's
    argmax for a while: bitwise ``verify_tokens_ref`` on the card and from
    a CUDA graph; its device time as a graph replay (sampled, and greedy),
    device busy and device kernels a call."""
    from repro_torch.kernels import prng
    from repro_torch.kernels.ref import verify_tokens_ref
    from repro_torch.kernels.speculative import verify_tokens_fused
    b, s, v = 8, SPEC_K + 1, 256000
    g = torch.Generator(device="cuda").manual_seed(6)
    logits = torch.randn((b, s, v), generator=g, device="cuda") * 3
    draft = logits[:, :SPEC_K].argmax(-1).to(torch.int32)
    draft[::3, 1:] = 7                      # some chains break early
    temp = torch.tensor([t for t, _ in SAMPLING], device="cuda")
    top_k = torch.tensor([k for _, k in SAMPLING], dtype=torch.int32,
                         device="cuda")
    key = prng.fold_in(prng.PRNGKey(SAMPLE_SEED, "cuda"),
                       torch.tensor(3, dtype=torch.int32, device="cuda"))
    got = verify_tokens_fused(logits, draft, temp, top_k, key)
    want = verify_tokens_ref(logits, draft, temp, top_k, key)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"verify_tokens_fused {[x.tolist() for x in got]}"
                             f" vs ref {[x.tolist() for x in want]}")
    graphs, outs = {}, {}
    for name, fn in (("sampled", lambda: verify_tokens_fused(
            logits, draft, temp, top_k, key)),
            ("greedy", lambda: verify_tokens_fused(logits, draft, temp,
                                                   top_k)),
            ("plain", lambda: verify_tokens_ref(logits, draft, temp, top_k,
                                                key))):
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            outs[name] = fn()
    graphs["sampled"].replay()
    if not all(torch.equal(x, y) for x, y in zip(outs["sampled"], want)):
        raise AssertionError("verify_tokens_fused replayed from a CUDA graph "
                             "gives other tokens")
    ms = {name: timer(gr.replay) for name, gr in graphs.items()}
    busy, kernels = _profiled_busy(
        torch, lambda: verify_tokens_fused(logits, draft, temp, top_k, key))
    del graphs, outs
    bound, by = bound_ms(4 * b * s * v + 4 * b * SPEC_K + 8 * b, 0,
                         F32_FLOP_PER_S)
    row = dict(shape=f"{b}x{s}x{v} f32", ms=ms["sampled"],
               greedy_ms=ms["greedy"], plain_ms=ms["plain"],
               device_busy_ms=busy, device_kernels=kernels, bound_ms=bound,
               bound_by=by, library_ms=None,
               n_advance=got[1].tolist())
    report["verify"] = row
    log(f"[verify] verify_tokens_fused {b}x{s}x{v} f32 (half the slots at 0.8 "
        f"/ top_k 40): bitwise the plain version on the card and from a CUDA "
        f"graph, n_advance {got[1].tolist()}; graph replay sampled "
        f"{fmt_ms(ms['sampled'])} (device busy {fmt_ms(busy)}, {kernels} "
        f"device kernels and copies), greedy {fmt_ms(ms['greedy'])}, plain "
        f"{fmt_ms(ms['plain'])}, bound {fmt_ms(bound)} ({by}); no library "
        f"call verifies")


def _sdpa_dense(torch, F, q, k, v, causal):
    """The library yardstick for the flash kernel: SDPA on K/V expanded to
    the query heads, with the bottom-right causal mask (queries the last
    Sq positions) when Sq != Skv (expansion and mask not timed)."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    group = hq // k.shape[1]
    ke = k.repeat_interleave(group, dim=1)
    ve = v.repeat_interleave(group, dim=1)
    if causal and sq != skv:
        mask = (torch.arange(sq, device="cuda")[:, None] + (skv - sq)
                >= torch.arange(skv, device="cuda")[None, :])
        return lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                      attn_mask=mask)
    return lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                  is_causal=causal)


def _sdpa_ms(torch, F, timer, q, kp, vp, bt, qpos):
    """The library yardstick: SDPA over the gathered, head-expanded K/V
    (gathering not timed).  Never called by the port."""
    b, hq, s, d = q.shape
    np_, ps = bt.shape[1], kp.shape[2]
    idx = bt.to(torch.int64)
    k = kp[idx].permute(0, 2, 1, 3, 4).reshape(b, 1, np_ * ps, d)
    v = vp[idx].permute(0, 2, 1, 3, 4).reshape(b, 1, np_ * ps, d)
    k, v = k.expand(b, hq, -1, -1).contiguous(), v.expand(b, hq, -1, -1) \
        .contiguous()
    kvpos = torch.arange(np_ * ps, device="cuda")
    mask = kvpos[None, None, :] <= (qpos[:, None].to(torch.int64)
                                    + torch.arange(s, device="cuda"))[:, :, None]
    mask = mask[:, None]
    qf = q.float()
    return yardstick(timer, lambda: F.scaled_dot_product_attention(
        qf, k, v, attn_mask=mask))


def yardstick(timer, fn):
    """Time a library call that computes the same function (a yardstick,
    never used by the port).  Its shape rules vary across torch versions:
    a refusal is reported and recorded as null, not a failed check."""
    try:
        return timer(fn)
    except RuntimeError as e:
        log(f"[check]   library yardstick refused: {str(e).splitlines()[0]}")
        return None


def run_path(torch, label, eng, prompts, gen_len, expect, sampling=None,
             first=(), block=8, walls=None):
    """Drive one path through the engine's entry points: the launch counts
    are set to 0 just before and read just after; every kernel named in
    ``expect`` must have launched, and a graphed engine must have run its
    blocks as CUDA graphs.  ``sampling``: per-prompt (temperature, top_k)
    (default greedy); blocks of the lengths in ``first``, then of
    ``block`` steps (rounds, under speculation).  ``walls``: a list that
    receives (wall ms, tokens, live lanes, steps, captured) per block.
    Returns (run summary, counts)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.lifecycle import RequestStatus
    sampling = sampling or [(0.0, 0)] * len(prompts)
    reset_launch_counts()
    t1 = time.perf_counter()
    ids = [eng.submit(p, gen_len=gen_len, temperature=t, top_k=k)
           for p, (t, k) in zip(prompts, sampling)]
    eng.try_admit()
    blocks = 0
    while eng.live.any() or eng.waiting:
        n = first[blocks] if blocks < len(first) else block
        live, captures = int(eng.live.sum()), eng.blocks.captures
        t0 = time.perf_counter()
        _, block_live = eng.step_many(n)
        if walls is not None:
            walls.append(((time.perf_counter() - t0) * 1e3,
                          int(block_live.sum()), live, n,
                          eng.blocks.captures != captures))
        blocks += 1
    eng.retire_finished()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    st = eng.stats()
    vocab = eng.cfg.vocab
    for i in ids:
        r = eng.results[i]
        if r["status"] is not RequestStatus.COMPLETED \
                or len(r["tokens"]) != gen_len \
                or not all(0 <= x < vocab for x in r["tokens"]):
            raise AssertionError(f"request {i} ({label}) did not complete"
                                 f" cleanly: {r['status']}, "
                                 f"{len(r['tokens'])} tokens")
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels of the path never launched: "
                             f"{missing} ({counts})")
    if st["graphs"] and st["graph_captures"] == 0:
        raise AssertionError(f"{label}: no decode block ran as a CUDA graph")
    run = dict(requests=len(ids), paged=eng.paged, kv_bits=eng.kv_bits,
               lut=eng.ctx.use_lut, quant=eng.ctx.mode,
               kv_split=eng.kv_split, pages_per_step=eng.pages_per_step,
               ttft_mean_s=st["ttft_mean_s"],
               decode_tok_per_s=st["decode_tok_per_s"], decode_s=st["decode_s"],
               gen_tokens=st["gen_tokens"], decode_steps=st["decode_steps"],
               prefill_chunks=st["prefill_chunks"], blocks=blocks,
               wall_s=wall, launches=counts, graphs=st["graphs"],
               graph_captures=st["graph_captures"],
               graph_capture_s=st["graph_capture_s"],
               streams=[eng.results[i]["tokens"] for i in ids])
    cache = (f"paged, knobs (pages_per_step={eng.pages_per_step}, "
             f"kv_split={eng.kv_split})" if eng.paged else "dense")
    log(f"[engine] {label}: served {len(ids)} requests x {gen_len} tokens "
        f"in {wall:.2f}s, {cache}, TTFT mean {st['ttft_mean_s']:.4f}s, "
        f"decode {st['decode_tok_per_s']:.1f} tok/s over {blocks} blocks "
        f"({st['decode_steps']} decode steps, {st['prefill_chunks']} prefill "
        f"chunks), {'CUDA graphs' if st['graphs'] else 'eager'} "
        f"({st['graph_captures']} captured in "
        f"{st['graph_capture_s']:.2f}s); kernel launches "
        f"{json.dumps(counts)}")
    return run, counts


def one_quantizer_per_qmatmul(label, counts) -> None:
    """Every int8 projection quantizes its activation in one launch."""
    if counts["quantize_rows"] != counts["qmatmul"]:
        raise AssertionError(f"{label}: quantize_rows launched "
                             f"{counts['quantize_rows']} times for "
                             f"{counts['qmatmul']} qmatmul launches")


def serve_main_path(torch, rows_out, profile: bool):
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
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_for_serving(lm.init(gen, cfg, device="cuda"), int8)
    torch.cuda.synchronize()
    log(f"[engine] gemma-2b full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; random int8 "
        f"weights in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    batch, plen, gen_len, chunk, ps = 8, 128, 32, 16, 16
    max_len = plen + gen_len + 1
    src = SyntheticLM(cfg.vocab, seed=0)
    prompts = [src.tokens(i, 1, plen)[0, :-1] for i in range(16)]
    geometry = dict(batch=batch, max_len=max_len, prefill_chunk=chunk,
                    page_size=ps, device="cuda")
    runs, total = {}, {}

    def record(label, run, counts):
        runs[label] = run
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # -- int8 weights, paged f32 KV cache (the first slice's path) ---------
    rows_out["logit_checks"] = logit_check(torch, cfg, params, int8, prompts,
                                           batch, max_len, chunk, ps, steps=4)
    engines = {}
    for label, knobs, reqs, expect in (
            ("int8 paged, auto knobs", {}, prompts,
             ("qmatmul", "paged_attention_split")),
            ("int8 paged, kv_split=1", {"kv_split": 1, "pages_per_step": 1},
             prompts[:batch], ("qmatmul", "paged_attention_unsplit"))):
        eng = Engine(cfg, int8, params, paged=True, **geometry, **knobs)
        engines[label] = eng
        run, counts = run_path(torch, label, eng, reqs, gen_len,
                               expect + ("quantize_rows",))
        one_quantizer_per_qmatmul(label, counts)
        record(label, run, counts)
    first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       None)
                  for a, b in zip(runs["int8 paged, auto knobs"]["streams"],
                                  runs["int8 paged, kv_split=1"]["streams"])]
    log(f"[engine] split vs unsplit kernel streams, first differing token per "
        f"request (None = identical): {first_diff} (bf16 logits of random "
        f"weights are full of near-ties; association order flips them)")
    rows_out["split_vs_unsplit_first_diff"] = first_diff

    # -- the sampled path: int8 paged, half the lanes sampled, graphed -----
    rows_out["sampled"] = serve_sampled(
        torch, cfg, int8, params, prompts[:batch], gen_len, geometry,
        greedy=runs["int8 paged, auto knobs"]["streams"][:batch],
        record=record)

    # -- regime (c): int8 weights + tables on the dense cache, int8 KV rows
    label = "int8 --lut --kv-bits 8, dense"
    lut8 = dataclasses.replace(int8, use_lut=True)
    eng = engines[label] = Engine(cfg, lut8, params, kv_bits=8, **geometry)
    run, counts = run_path(torch, label, eng, prompts[:batch], gen_len,
                           ("qmatmul", "quantize_rows"))
    one_quantizer_per_qmatmul(label, counts)
    if counts["lut_activation"] != 0 or counts["lut_gated_mul"] != 0:
        raise AssertionError(f"{label}: the table belongs in qmatmul's "
                             f"epilogue, yet a table kernel launched "
                             f"({counts})")
    record(label, run, counts)

    # -- regime (a): bf16 weights, every gated GELU through lut_gated_mul --
    lutf = QuantContext(mode="none", use_lut=True,
                        compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    bf16 = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                   dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[engine] random bf16 weights in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    rows_out["logit_checks_lut"] = logit_check(
        torch, cfg, bf16, lutf, prompts, batch, max_len, chunk, ps, steps=4)
    label = "--lut --paged, bf16 weights"
    eng = engines[label] = Engine(cfg, lutf, bf16, paged=True, **geometry)
    run, counts = run_path(torch, label, eng, prompts[:batch], gen_len,
                           ("lut_gated_mul", "paged_attention_split"))
    want = cfg.n_layers * (run["decode_steps"] + run["prefill_chunks"])
    stray = {k: counts[k] for k in ("lut_activation", "qmatmul",
                                    "quantize_rows") if counts[k]}
    if counts["lut_gated_mul"] != want or stray:
        raise AssertionError(
            f"{label}: lut_gated_mul launched {counts['lut_gated_mul']} "
            f"times, expected {cfg.n_layers} layers x ({run['decode_steps']} "
            f"decode steps + {run['prefill_chunks']} prefill chunks) = {want}"
            f"; expected no {sorted(stray)} launches ({stray})")
    record(label, run, counts)

    # -- graphs off against graphs on, paths 1, 3 and 4, in this process --
    ab_len = plen + AB_GEN + 1
    # a page pool that holds every lane's budget: all 8 admitted at once
    pool = dict(paged=True, num_pages=2 * batch * -(-ab_len // ps))
    rows_out["graphs_ab"] = graphs_ab(torch, cfg, [
        ("1 int8 paged, auto", int8, params, pool),
        ("3 int8 --lut --kv-bits 8, dense", lut8, params, dict(kv_bits=8)),
        ("4 --lut --paged, bf16", lutf, bf16, pool)],
        prompts[:batch], dict(geometry, max_len=ab_len))

    # -- path 6: speculative decoding on path 1's configuration ------------
    rows_out["spec"] = serve_spec(torch, cfg, int8, params, prompts[:batch],
                                  gen_len, geometry, record=record)

    for r in runs.values():
        r.pop("streams", None)
    rows_out["serving"] = runs
    rows_out["launches"] = total
    split_per_path = {label: r["launches"]["paged_attention_split"]
                      for label, r in runs.items()}
    rows_out["split_launches_per_path"] = split_per_path
    log(f"[engine] paged_attention_split launches per path (one launch per "
        f"layer and model call, the combine inside it): "
        f"{json.dumps(split_per_path)}")
    log(f"[engine] main-path launches over all paths: {json.dumps(total)}")

    if profile:
        # an optional diagnostic, after every phase has passed: a profiler
        # that cannot trace this machine is reported, not fatal
        rows_out["profile"] = {}
        for label, eng in engines.items():
            log(f"[profile] {label}")
            try:
                rows_out["profile"][label] = profile_block(torch, eng,
                                                           prompts, gen_len)
            except (RuntimeError, AttributeError) as e:
                log(f"[profile] failed: {e!r}")
    return total


#: the sampled path: half the lanes at temperature 0.8 and top_k 40, half
#: greedy, keyed by this seed
SAMPLING, SAMPLE_SEED = [(0.8, 40), (0.0, 0)] * 4, 1


def serve_sampled(torch, cfg, ctx, params, prompts, gen_len, geometry, *,
                  greedy, record):
    """int8 paged gemma-2b at full width, 8 requests, half sampled (0.8,
    top_k 40), half greedy: served eagerly and through CUDA graphs, whose
    streams must be identical (tokens in range, every request complete),
    as must their launch counts; then through graphs in blocks of 2 + 3
    and of 5 (then 8), whose streams must be identical too: step ``i``
    of the engine draws ``fold_in(key, i)``, whatever the block split.
    The graphed run's counts join the main path's.  ``greedy``: path 1's
    greedy streams of the same prompts, for the log only."""
    from repro_torch.launch.serve import Engine
    runs = {}
    for label, graphs, first in (("eager", False, ()), ("graphs", True, ()),
                                 ("graphs, blocks 2+3", True, (2, 3)),
                                 ("graphs, blocks 5", True, (5,))):
        eng = Engine(cfg, ctx, params, paged=True, seed=SAMPLE_SEED,
                     graphs=graphs, **geometry)
        run, counts = run_path(
            torch, f"sampled int8 paged, {label}", eng, prompts, gen_len,
            ("qmatmul", "paged_attention_split", "quantize_rows"),
            sampling=SAMPLING, first=first)
        one_quantizer_per_qmatmul(label, counts)
        runs[label] = run
        del eng
    if runs["graphs"]["streams"] != runs["eager"]["streams"] \
            or runs["graphs"]["launches"] != runs["eager"]["launches"]:
        raise AssertionError("sampled path: graphed streams or launch counts "
                             "differ from eager ones")
    if runs["graphs, blocks 2+3"]["streams"] \
            != runs["graphs, blocks 5"]["streams"]:
        raise AssertionError("sampled path: blocks of 2 + 3 and of 5 give "
                             "different streams")
    streams = runs["graphs"]["streams"]
    same = [a == b for a, b in zip(streams, greedy)]
    log(f"[sampled] graphed streams == eager streams, blocks 2+3 == blocks "
        f"5: yes; equal to path 1's greedy stream of the same prompt: "
        f"sampled requests {same[0::2]}, greedy requests {same[1::2]}; "
        f"decode {runs['eager']['decode_tok_per_s']:.1f} tok/s eager, "
        f"{runs['graphs']['decode_tok_per_s']:.1f} graphed")
    record("sampled int8 paged, graphs", runs["graphs"],
           runs["graphs"]["launches"])
    out = {}
    for label, r in runs.items():
        out[label] = {k: v for k, v in r.items() if k != "streams"}
    out["equal_to_greedy"] = same
    return out


#: path 6's gate on greedy spec streams against path 1's plain ones: the
#: verify pass computes logits at M 40 (plain decode at M 8), so cuBLAS's
#: unembed and torch's reductions may round otherwise; a stream may part
#: only where the plain Engine's own top-2 margin is below this
SPEC_MARGIN_BOUND = 1e-3


def plain_margins(torch, eng, prompts, streams):
    """The plain Engine's own logits along its streams: ``eng`` (fresh,
    the plain run's configuration) prefills ``prompts``, then decode
    steps at the same batch, cache and knobs, every lane teacher-forced
    along its stream.  Returns per lane the top-2 margin of the logits
    that chose each token (token 0 is the prefill's, shared by both
    engines: None); fails if the replay's argmax is not the stream."""
    from repro_torch.train.step import build_serve_step
    step = build_serve_step(eng.cfg, eng.ctx)
    b, n = len(prompts), len(streams[0])
    eng.add_requests(dict(enumerate(prompts)), gen_len=n)
    pos = torch.tensor(eng.pos, dtype=torch.int32, device="cuda")
    toks = torch.tensor([[s[0]] for s in streams], dtype=torch.int32,
                        device="cuda")
    if toks[:, 0].tolist() != eng.tokens[:, 0].tolist():
        raise AssertionError("plain margins: the replayed prefill chose "
                             "other first tokens")
    margins = [[None] for _ in range(b)]
    for t in range(n - 1):
        logits, eng.cache = step(eng.params, eng.cache, toks, pos)
        last = logits[:, -1].float()
        top2 = last.topk(2, dim=-1).values
        want = torch.tensor([s[t + 1] for s in streams], device="cuda")
        if not torch.equal(last.argmax(-1), want):
            raise AssertionError(f"plain margins: decode step {t} of the "
                                 f"replay does not reproduce the streams")
        for r, m in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
            margins[r].append(m)
        toks, pos = want.to(torch.int32)[:, None], pos + 1
    return margins


def spec_gate(label, streams, plain, margins, *, gated=True):
    """Path 6's gate 2: every stream equals path 1's plain one, or first
    parts where the plain Engine's top-2 margin is below
    SPEC_MARGIN_BOUND; logged and returned per lane as (position,
    margin), None when identical.  ``gated=False`` logs only."""
    out = []
    for r, (a, b) in enumerate(zip(streams, plain)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            out.append(None)
            continue
        m = margins[r][i]
        out.append((i, m))
        log(f"[spec] {label}: lane {r} parts from the plain stream at token "
            f"{i}, plain top-2 margin {m}" + ("" if gated else
                                              " (logged, not gated)"))
        if gated and (m is None or m >= SPEC_MARGIN_BOUND):
            raise AssertionError(f"{label}: lane {r} parts from the plain "
                                 f"stream at token {i} where the plain "
                                 f"margin is {m}")
    return out


def _steady(walls):
    """Wall per block-step, per round and per committed token of the blocks
    that captured no graph: (ms per step, ms per committed token of a live
    lane, committed tokens per step of all lanes)."""
    w = [x for x in walls if not x[4]]
    if not w:
        return None, None, None
    ms = sum(x[0] for x in w)
    steps = sum(x[3] for x in w)
    lane_tokens = sum(x[1] / max(x[2], 1) for x in w)
    return ms / steps, ms / lane_tokens, sum(x[1] for x in w) / steps


#: path 6's runs: (label, target cache, drafter, sampled lanes, least
#: drafts accepted per live round, streams gated against the plain run's)
SPEC_RUNS = [("a ngram", "paged", "ngram", False, None, True),
             ("b self-draft", "paged", "self", False, None, True),
             ("b* chain drafter", "paged", "chain", False, 3.0, True),
             ("b' self-draft, dense target", "dense", "self", False, None,
              False),
             ("c ngram, half sampled", "paged", "ngram", True, None, False)]


def chain_drafter(torch, streams, plen: int):
    """A drafter that proposes each lane's next SPEC_K tokens of
    ``streams`` (prompts all ``plen`` long): fed the (a) run's committed
    streams, the target's own greedy chain under the verify pass's
    numerics, so every draft should survive (the full-acceptance and
    bonus-token path).  Device ops only: it is captured with the block."""
    table = torch.tensor([list(x) + [x[-1]] * (SPEC_K + 1) for x in streams],
                         dtype=torch.int64, device="cuda")
    steps = torch.arange(1, SPEC_K + 1, device="cuda")[None, :]

    def drafter(hist, tok, pos):
        idx = pos.to(torch.int64)[:, None] - plen + steps
        return torch.gather(table, 1, idx.clamp(0, table.shape[1] - 1))
    return drafter


def serve_spec(torch, cfg, ctx, params, prompts, gen_len, geometry, *,
               record):
    """Path 6: path 1's configuration (int8 weights, paged f32 KV at the
    auto knobs, batch 8, prompt 128, gen 32, page 16) with speculative
    decoding, spec_k SPEC_K, graphed, on tiled (repetitive) prompts: (a)
    the n-gram drafter; (b) the target as its own draft model (same cfg,
    params and ctx), whose dense draft cache attends through the einsum
    path (bf16 operands), not the paged kernel, so its drafts part from
    the target's chain wherever that rounding flips an argmax; (b*) a
    drafter that proposes (a)'s committed streams, the target's own chain,
    so every greedy draft should survive (the full-acceptance and
    bonus-token path); (b') (b) on the dense target cache (drafter and
    target on the einsum path); (c) (a) with half the lanes at
    temperature 0.8 and top_k 40.  Gates: greedy streams equal the plain
    Engine's on the same prompts and cache (spec_gate; (b') is logged,
    not gated: ROADMAP.md queue 3); graphed == eager streams and launch
    counts; (c) in blocks of 2 + 3 rounds == blocks of 5; qmatmul,
    quantize_rows (one per qmatmul) and, paged, split paged attention
    launched; (b*) accepts >= 3.0 of SPEC_K drafts per live round.
    Logged per run: accepted per round, committed tokens per verify pass,
    wall per committed token beside the plain run's wall per step, device
    busy per round."""
    import numpy as np
    from repro_torch.launch.serve import Engine
    tiled = [np.tile(p[:8], len(p) // 8 + 1)[:len(p)] for p in prompts]
    expect = {"paged": ("qmatmul", "quantize_rows", "paged_attention_split"),
              "dense": ("qmatmul", "quantize_rows")}
    out, runs, walls, plain, margins = {}, {}, {}, {}, {}

    def engine(cache, graphs, **kw):
        return Engine(cfg, ctx, params, paged=cache == "paged",
                      graphs=graphs, seed=SAMPLE_SEED, **geometry, **kw)

    drafters = {}

    def spec_kw(drafter):
        kw = dict(spec=True, spec_k=SPEC_K)
        if drafter == "self":
            kw["spec_draft"] = (cfg, params, ctx)
        elif drafter == "chain":
            kw["drafter_fn"] = drafters["chain"]
        return kw

    for cache in ("paged", "dense"):
        label = f"path 6 plain, tiled prompts, {cache}"
        walls[label] = []
        runs[label], _ = run_path(torch, label, engine(cache, True), tiled,
                                  gen_len, expect[cache], walls=walls[label])
        plain[cache] = runs[label]["streams"]
        margins[cache] = plain_margins(torch, engine(cache, False), tiled,
                                       plain[cache])
    for kind, cache, drafter, sampled, least, gated in SPEC_RUNS:
        sampling = SAMPLING if sampled else None
        arms = [("graphs", True, ()), ("eager", False, ())]
        if sampled:
            arms += [("graphs, blocks 2+3", True, (2, 3)),
                     ("graphs, blocks 5", True, (5,))]
        for arm, graphs, first in arms:
            label = f"path 6 spec {kind}, {arm}"
            walls[label] = []
            eng = engine(cache, graphs, **spec_kw(drafter))
            run, counts = run_path(
                torch, label, eng, tiled, gen_len, expect[cache],
                sampling=sampling, first=first, block=5 if first else 2,
                walls=walls[label])
            one_quantizer_per_qmatmul(label, counts)
            st = eng.stats()
            run.update(accepted_per_step=st["accepted_per_step"],
                       verify_steps=st["verify_steps"],
                       committed_per_verify=st["gen_tokens"]
                       / max(st["verify_steps"], 1))
            runs[label] = run
            del eng
        g, e = runs[f"path 6 spec {kind}, graphs"], \
            runs[f"path 6 spec {kind}, eager"]
        if g["streams"] != e["streams"] or g["launches"] != e["launches"]:
            raise AssertionError(f"path 6 {kind}: graphed streams or launch "
                                 f"counts differ from eager ones")
        if sampled and runs[f"path 6 spec {kind}, graphs, blocks 2+3"][
                "streams"] != runs[f"path 6 spec {kind}, graphs, blocks 5"][
                "streams"]:
            raise AssertionError(f"path 6 {kind}: blocks of 2 + 3 rounds and "
                                 f"of 5 give different streams")
        gate = None if sampled else spec_gate(
            kind, g["streams"], plain[cache], margins[cache], gated=gated)
        if kind.startswith("a "):
            drafters["chain"] = chain_drafter(torch, g["streams"],
                                              len(tiled[0]))
        if least is not None and g["accepted_per_step"] < least:
            raise AssertionError(f"path 6 {kind}: {g['accepted_per_step']:.3f}"
                                 f" drafts accepted per round, expected >= "
                                 f"{least} of {SPEC_K}")
        record(f"spec {kind}, graphs", g, g["launches"])
        out[kind] = dict(gate_vs_plain=gate, graphs=g, eager=e)
    # steady state (blocks that captured nothing) and device busy per round
    steady = {cache: _steady(walls[f"path 6 plain, tiled prompts, {cache}"])
              [0] for cache in ("paged", "dense")}
    for kind, cache, drafter, sampled, _, _ in SPEC_RUNS:
        g = out[kind]["graphs"]
        per_round, per_token, tokens = _steady(
            walls[f"path 6 spec {kind}, graphs"])
        eng = engine(cache, True, **spec_kw(drafter))
        for p, (t, k) in zip(tiled, SAMPLING if sampled
                             else [(0.0, 0)] * len(tiled)):
            eng.submit(p, gen_len=gen_len, temperature=t, top_k=k)
        eng.try_admit()
        eng.step_many(1)                      # eager block and capture
        top = []
        busy, kernels = _profiled_busy(torch, lambda: eng.step_many(1), top)
        del eng
        g.update(wall_ms_per_round=per_round,
                 wall_ms_per_committed_token=per_token,
                 committed_tokens_per_round=tokens,
                 device_busy_ms_per_round=busy,
                 device_kernels_per_round=kernels,
                 device_top=[dict(kernel=k, ms=ms, count=n)
                             for k, ms, n in top],
                 plain_wall_ms_per_step=steady[cache])
        log(f"[spec] {kind}: accepted_per_step {g['accepted_per_step']:.3f} "
            f"of {SPEC_K}, {g['committed_per_verify']:.3f} committed tokens "
            f"per verify pass (all lanes: {tokens:.2f} a round); wall "
            f"{per_round:.3f} ms a round, {per_token:.3f} ms per committed "
            f"token of a live lane, against the plain {cache} run's graphed "
            f"{steady[cache]:.3f} ms a step; device busy {fmt_ms(busy)} a "
            f"round ({kernels} device kernels and copies)")
        for k, ms, n in top[:6]:
            log(f"[spec]   {ms:8.3f} ms  x{n:<5d} {k[:90]}")
    for r in runs.values():
        r.pop("streams", None)
    for cache in ("paged", "dense"):
        out[f"plain {cache}"] = dict(
            runs[f"path 6 plain, tiled prompts, {cache}"],
            wall_ms_per_step=steady[cache])
    out["others"] = {k: v for k, v in runs.items() if "blocks" in k}
    return out


#: the graphs A/B: 8 lanes, 56 tokens each, so that the warm block, three
#: timed blocks and two profiled ones per arm run with every lane live
AB_GEN = 56


def _profiled_busy(torch, fn, top=None):
    """(device busy ms, device kernels and copies) of ``fn`` under
    torch.profiler, the second of two traced runs (the first starts the
    tracer); (None, 0) when the trace holds no device time.  ``top``: a
    list that receives the 12 longest (kernel, ms, count)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    rows = device_rows(prof)
    if top is not None:
        top.extend(rows[:12])
    busy = sum(r[1] for r in rows)
    return (busy if busy > 0 else None), sum(r[2] for r in rows)


def graphs_ab(torch, cfg, paths, prompts, geometry):
    """Each path with graphs off and on, on the same prompts, in turns on
    this card: 8-step blocks with all lanes live, wall per step on the
    host clock (upload to download) three times per arm (off, on, on,
    off, off, on: three pairs), then device busy and device kernels per
    step under the profiler.  Path 1 adds a third arm, graphs on with
    every lane sampled (0.8, top_k 40): what sampling costs a step.  The
    off and on streams and launch counts (whole runs) must be identical."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import Engine
    out = {}
    for label, ctx, params, kw in paths:
        arms = {"off": (False, (0.0, 0)), "on": (True, (0.0, 0))}
        if label.startswith("1 "):
            arms["on, sampled"] = (True, (0.8, 40))
        engs, ids, counts = {}, {}, {}

        def counted(arm, fn):
            reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            for k, v in launch_counts().items():
                counts[arm][k] = counts[arm].get(k, 0) + v

        for arm, (graphs, (t, k)) in arms.items():
            eng = engs[arm] = Engine(cfg, ctx, params, graphs=graphs,
                                     seed=SAMPLE_SEED, **geometry, **kw)
            counts[arm] = {}
            counted(arm, lambda: ids.__setitem__(arm, [
                eng.submit(p, gen_len=AB_GEN, temperature=t, top_k=k)
                for p in prompts]))
            counted(arm, eng.try_admit)
            counted(arm, lambda: eng.step_many(8))   # warm (on: + capture)
        walls = {arm: [] for arm in arms}
        order = list(arms) + list(arms)[::-1] + list(arms)
        for arm in order:
            t0 = time.perf_counter()
            counted(arm, lambda: engs[arm].step_many(8))
            walls[arm].append((time.perf_counter() - t0) * 1e3 / 8)
        busy = {}
        for arm in arms:
            ms, n = _profiled_busy(
                torch, lambda: counted(arm, lambda: engs[arm].step_many(8)))
            busy[arm] = (None if ms is None else ms / 8, n / 8)
        for arm, eng in engs.items():
            if not eng.live.all():
                raise AssertionError(f"graphs A/B {label} {arm}: a lane "
                                     f"finished inside the measured blocks")
            while eng.live.any():
                counted(arm, lambda: eng.step_many(8))
            eng.retire_finished()
        streams = {arm: [engs[arm].results[i]["tokens"] for i in ids[arm]]
                   for arm in arms}
        if streams["on"] != streams["off"] or counts["on"] != counts["off"]:
            raise AssertionError(f"graphs A/B {label}: graphed streams or "
                                 f"launch counts differ from eager ones "
                                 f"({counts['on']} vs {counts['off']})")
        if any(len(x) != AB_GEN for x in streams["on"]):
            raise AssertionError(f"graphs A/B {label}: short streams")
        row = {}
        for arm in arms:
            w = walls[arm]
            row[arm] = dict(wall_ms_per_step=w,
                            wall_spread=(max(w) - min(w)) / statistics
                            .median(w),
                            device_busy_ms_per_step=busy[arm][0],
                            device_kernels_per_step=busy[arm][1],
                            launches=counts[arm],
                            graph_captures=engs[arm].blocks.captures)
            log(f"[graphs] path {label}, graphs {arm}: wall per step "
                f"{' / '.join(f'{x:.3f}' for x in w)} ms (spread "
                f"{100 * row[arm]['wall_spread']:.1f}%), device busy per "
                f"step {fmt_ms(busy[arm][0])}, {busy[arm][1]:.1f} device "
                f"kernels and copies per step")
        off, on = (statistics.median(walls[a]) for a in ("off", "on"))
        log(f"[graphs] path {label}: streams and launch counts identical, "
            f"graphs off/on; wall per step {off:.3f} -> {on:.3f} ms "
            f"(medians, {off / on:.2f}x)")
        out[label] = row
        del engs
        torch.cuda.synchronize()
    return out


#: path 7: the jet-tagging MLP at a single event and at a large batch
JET_BATCHES = (1, 16384)


def serve_jet(torch, report) -> dict:
    """Path 7: the paper's jet-tagging MLP (16 -> 64 -> 32 -> 32 -> 5,
    ``repro_torch.models.mlp``), random weights from a seed, f32 compute,
    at batch 1 and 16384: f32 weights (``torch.matmul``: held against the
    CPU's forward), int8 PTQ weights (every layer through quantize_rows and
    qmatmul) and int8 with the table softmax (``predict`` under
    ``use_lut``); the int8 logits and probabilities bitwise the plain
    versions' on the card, the launch counts reset just before and read
    just after (one quantize_rows per qmatmul, four of each per forward).
    Time per batch, warm (a deployed tagger's 4 KB of weights stay in L2):
    the eager forward between CUDA events (the host's enqueue included),
    the same forward as a CUDA graph replay (checked bitwise against the
    eager output), and the device busy time and device kernels of one
    eager forward (torch.profiler), beside the least time the card could
    take (the input read once, the output written once, the weights once;
    the products at the int8 or f32 peak).  Returns the launch counts of
    the checked forwards (the timing runs' are not counted)."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.core.quantize import ptq_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import mlp
    from repro_torch.nn.context import QuantContext
    pol = PrecisionPolicy.uniform(FixedPointType(8, 4))
    f32 = QuantContext(mode="none", compute_dtype=torch.float32)
    int8 = QuantContext(mode="int8", policy=pol, compute_dtype=torch.float32)
    lut = dataclasses.replace(int8, use_lut=True)
    params = mlp.init(torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    ptq = ptq_params(params, pol)
    macs = sum(k * n for _, k, n in JET_PROJ)
    wbytes = {"f32": sum(4 * (k * n + n) for _, k, n in JET_PROJ),
              "int8": sum(k * n + 8 * n for _, k, n in JET_PROJ)}
    rows, total = [], {}
    for b in JET_BATCHES:
        x = torch.randn((b, 16), generator=torch.Generator(device="cuda")
                        .manual_seed(b), device="cuda") * 1.5
        for name, weights, ctx, fn in (
                ("f32", params, f32, mlp.forward),
                ("int8 ptq", ptq, int8, mlp.forward),
                ("int8 ptq + lut softmax", ptq, lut, mlp.predict)):
            reset_launch_counts()
            got = fn(weights, x, ctx)
            torch.cuda.synchronize()
            counts = launch_counts()
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            if ctx.mode == "int8" and not (
                    counts["qmatmul"] == counts["quantize_rows"]
                    == len(JET_PROJ)):
                raise AssertionError(f"path 7 jet MLP {name}, batch {b}: "
                                     f"expected {len(JET_PROJ)} qmatmul and "
                                     f"quantize_rows launches ({counts})")
            if ctx.mode == "int8":
                want = fn(weights, x, dataclasses.replace(ctx, backend="ref"))
                err = (got - want).abs().max().item()
                ok = torch.equal(got, want)
            else:
                want = fn({k: {n: t.cpu() for n, t in v.items()}
                           for k, v in weights.items()}, x.cpu(), ctx)
                err = (got.cpu() - want).abs().max().item()
                ok = err <= 1e-4
            if not (ok and got.shape == (b, 5)
                    and torch.isfinite(got).all().item()):
                raise AssertionError(f"path 7 jet MLP {name}, batch {b}: "
                                     f"max_abs_err {err}")
            ms = event_ms(torch, lambda: fn(weights, x, ctx), reps=9)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = fn(weights, x, ctx)
            graph.replay()
            if not torch.equal(replayed, got):
                raise AssertionError(f"path 7 jet MLP {name}, batch {b}: a "
                                     f"CUDA graph replay gives other outputs")
            graph_ms = event_ms(torch, graph.replay, reps=9)
            del graph
            busy, kernels = _profiled_busy(torch, lambda: fn(weights, x, ctx))
            kind = "int8" if ctx.mode == "int8" else "f32"
            nbytes = 4 * b * 16 + 4 * b * 5 + wbytes[kind]
            bnd, by = bound_ms(nbytes, 2.0 * b * macs,
                               INT8_OPS_PER_S if kind == "int8"
                               else F32_FLOP_PER_S)
            rows.append(dict(config=name, batch=b, eager_us=ms * 1e3,
                             graph_us=graph_ms * 1e3,
                             device_busy_us=None if busy is None
                             else busy * 1e3, device_kernels=kernels,
                             bound_us=bnd * 1e3, bound_by=by,
                             max_abs_err=err, bitwise=kind == "int8"))
            log(f"[jet] {name}, batch {b}: "
                + ("bitwise the plain versions" if kind == "int8"
                   else f"max_abs_err {err:.3g} vs the CPU (tol 1e-4)")
                + f"; a batch: eager {ms * 1e3:.2f} us, graph replay "
                f"{graph_ms * 1e3:.2f} us, device busy "
                f"{'n/a' if busy is None else f'{busy * 1e3:.2f} us'} "
                f"({kernels} device kernels and copies); bound "
                f"{bnd * 1e3:.4f} us ({by})")
    log(f"[jet] kernel launches of path 7's checked forwards: "
        f"{json.dumps(total)}")
    report["jet"] = dict(rows=rows, launches=total)
    return total


#: path 5: whisper-base, batch 8, 1500 encoder frames (the 30-second
#: window after the stubbed conv front end), a 16-token decoder prompt,
#: 32 greedy tokens in blocks of 8
WHISPER = dict(batch=8, frames=1500, plen=16, gen=32, block=8)


def serve_whisper(torch, report, profile: bool):
    """Path 5: whisper-base at full width through the serving step
    builders (the Engine refuses encdec, as the reference Engine never
    runs an encoder), with bf16 and with int8 weights, bf16 compute, the
    f32 dense KV cache.  Per weight type: the logit check (kernels vs
    plain, one prefill and 4 teacher-forced decode steps, and the planted
    faults it must catch), then one
    counted run -- counts reset just before the prefill and read after
    the last decode block: flash_attention must launch exactly once per
    encoder layer (6), qmatmul 0 (bf16) or > 0 (int8) times.  Returns the
    launch counts summed over both runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import prepare_params, quantize_for_serving
    from repro_torch.models import encdec
    from repro_torch.models.api import init_cache_fn
    from repro_torch.nn.context import QuantContext
    from repro_torch.train.step import build_decode_loop, build_prefill_step

    cfg = get_config("whisper-base")
    w = WHISPER
    b, plen, gen = w["batch"], w["plen"], w["gen"]
    nb = make_batch(cfg, 0, b, w["frames"], seed=0)
    batch = {"tokens": torch.from_numpy(nb["tokens"][:, :plen]).cuda(),
             "enc_input": torch.from_numpy(nb["enc_input"]).cuda()}
    log(f"[whisper] whisper-base full width: {cfg.enc_layers}+{cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; batch {b}, "
        f"{w['frames']} encoder frames, prompt {plen}, {gen} greedy tokens "
        f"in blocks of {w['block']}")
    runs, total = {}, {}
    for label, mode in (("bf16 weights", "none"), ("int8 weights", "int8")):
        ctx = QuantContext(
            mode=mode, compute_dtype=torch.bfloat16,
            policy=(PrecisionPolicy.uniform(FixedPointType(8, 4))
                    if mode == "int8" else PrecisionPolicy()))
        gen_t = torch.Generator(device="cuda").manual_seed(0)
        if mode == "int8":
            params = quantize_for_serving(
                encdec.init(gen_t, cfg, device="cuda"), ctx)
        else:
            params = encdec.init(gen_t, cfg, dtype=torch.bfloat16,
                                 device="cuda")
        params = prepare_params(params, ctx, "cuda")
        checks = whisper_logit_check(torch, cfg, params, ctx, batch, steps=4)

        prefill_step = build_prefill_step(cfg, ctx)
        loop = build_decode_loop(cfg, ctx, w["block"])
        cache = init_cache_fn(cfg, b, plen + gen, torch.float32, "cuda")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, batch, cache)
        tok = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pos = torch.full((b,), plen, dtype=torch.int32, device="cuda")
        live = torch.ones((b,), dtype=torch.bool, device="cuda")
        stop = torch.full((b,), plen + gen, dtype=torch.int32, device="cuda")
        greedy = {"temperature": torch.zeros((b,), device="cuda"),
                  "top_k": torch.zeros((b,), dtype=torch.int32,
                                       device="cuda")}
        streams = []
        t1 = time.perf_counter()
        for i in range(gen // w["block"]):
            cache, tok, pos, live, bt, bl, fault = loop(
                params, cache, tok, pos, live, stop, greedy, None,
                i * w["block"], -1)
            streams.append(bt.cpu())          # the host's one sync a block
            if fault.any().item():
                raise AssertionError(f"whisper {label}: non-finite logits")
        decode_s = time.perf_counter() - t1
        counts = launch_counts()
        toks = torch.cat(streams).T
        if not (toks.shape == (b, gen) and toks.min() >= 0
                and toks.max() < cfg.vocab and not live.any().item()):
            raise AssertionError(f"whisper {label}: streams "
                                 f"{tuple(toks.shape)} out of range or "
                                 f"still live")
        want_q = counts["qmatmul"] > 0 if mode == "int8" \
            else counts["qmatmul"] == 0
        others = {k: v for k, v in counts.items()
                  if k not in ("flash_attention", "qmatmul", "quantize_rows")
                  and v}
        if counts["flash_attention"] != cfg.enc_layers or not want_q \
                or counts["quantize_rows"] != counts["qmatmul"] or others:
            raise AssertionError(
                f"whisper {label}: launches {counts}; expected "
                f"flash_attention = {cfg.enc_layers} (one prefill), qmatmul "
                f"{'> 0' if mode == 'int8' else '0'}, quantize_rows as many "
                f"as qmatmul, nothing else")
        encode_ms = event_ms(torch, lambda: encdec.encode(
            params, batch["enc_input"], cfg, ctx))
        run = dict(weights=label, prefill_s=prefill_s, encode_ms=encode_ms,
                   decode_s=decode_s, decode_tok_per_s=b * gen / decode_s,
                   gen_tokens=b * gen, launches=counts, logit_checks=checks)
        runs[label] = run
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        log(f"[whisper] {label}: prefill (encode {w['frames']} frames + "
            f"cross K/V + {plen}-token prompt) {prefill_s * 1e3:.2f} ms, "
            f"encode alone {encode_ms:.2f} ms (CUDA events), decode {b * gen} tokens in "
            f"{decode_s:.3f}s = {run['decode_tok_per_s']:.1f} tok/s; "
            f"launches {json.dumps(counts)}")
        if profile:
            try:
                run["profile"] = profile_whisper(torch, cfg, ctx, params,
                                                 batch, prefill_step, loop)
            except (RuntimeError, AttributeError) as e:
                log(f"[profile] failed: {e!r}")
        del params, cache
        torch.cuda.synchronize()
    report["whisper"] = runs
    log(f"[whisper] launches over both runs: {json.dumps(total)}")
    return total


def event_ms(torch, fn, reps: int = 5) -> float:
    """Median device time of ``fn`` (warm), CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


#: gates of path 5's logit check (whisper-base, kernels vs plain): set
#: between the sound runs' largest reading and the planted faults'
#: readings (PERF.md section 6)
WHISPER_TOL_REL, WHISPER_MIN_AGREE = 0.05, 0.9


def _causal_encoder(encdec, torch):
    """Planted fault: the encoder's self-attention made causal."""
    f = encdec.dense_block_apply
    return "dense_block_apply", lambda *a, **kw: f(*a, **{**kw,
                                                        "causal": True})


def _zero_cross_kv(encdec, torch):
    """Planted fault: every decoder layer's cross K/V zeroed."""
    f = encdec.gqa_project_kv
    return "gqa_project_kv", lambda *a, **kw: tuple(
        torch.zeros_like(t) for t in f(*a, **kw))


WHISPER_FAULTS = {"causal encoder": _causal_encoder,
                  "zeroed cross K/V": _zero_cross_kv}


def whisper_logit_check(torch, cfg, params, ctx, batch, *, steps: int):
    """Full-width whisper logits of the prefill (every prompt position)
    and ``steps`` teacher-forced decode steps (the plain side's argmax),
    through the kernels and through the plain versions
    (``backend="ref"``), from the same weights and inputs, each run with
    its own dense cache; gated at WHISPER_TOL_REL / WHISPER_MIN_AGREE.
    Then each planted fault of WHISPER_FAULTS, patched into the kernels'
    run only, must fail that gate at some step: the gate is shown to
    catch a wrong encoder and wrong cross K/V in every run."""
    from repro_torch.models import encdec
    b, plen = batch["tokens"].shape

    def run(c, forced=None):
        cache = encdec.init_cache(cfg, b, plen + steps + 1, torch.float32,
                                  "cuda")
        out, toks = [], []
        for step in range(steps + 1):
            if step == 0:
                logits, cache = encdec.prefill(params, batch, cache, cfg, c,
                                               full_logits=True)
            else:
                pos = torch.full((b,), plen + step - 1, dtype=torch.int32,
                                 device="cuda")
                tok = (toks if forced is None else forced)[step - 1]
                logits, cache = encdec.decode_step(params, tok, cache, pos,
                                                   cfg, c)
            out.append(logits.float())
            toks.append(out[-1][:, -1].argmax(-1).to(torch.int32)[:, None])
        return out, toks

    def what(step):
        return "prefill" if step == 0 else f"decode step {step}"

    plain, forced = run(dataclasses.replace(ctx, backend="ref"))
    got, _ = run(ctx, forced)
    gate = dict(tol_rel=WHISPER_TOL_REL, min_agree=WHISPER_MIN_AGREE)
    checks = [gate_logits(torch, "[whisper]",
                          f"whisper {ctx.mode}: {what(step)}", lk, lp,
                          ctx.compute_dtype, **gate)
              for step, (lk, lp) in enumerate(zip(got, plain))]
    for fault, plant in WHISPER_FAULTS.items():
        attr, patched = plant(encdec, torch)
        orig = getattr(encdec, attr)
        setattr(encdec, attr, patched)
        try:
            got, _ = run(ctx, forced)
        finally:
            setattr(encdec, attr, orig)
        readings = [logit_readings(lk, lp) for lk, lp in zip(got, plain)]
        caught = [r for r in readings if not passes_gate(r, **gate)]
        worst_rel = max(r["rel_l2_err"] for r in readings)
        worst_agree = min(r["argmax_agree"] for r in readings)
        log(f"[whisper] planted fault '{fault}' ({ctx.mode} weights): "
            f"relative L2 up to {worst_rel:.4g}, argmax agreement down to "
            f"{worst_agree:.4f}; fails the gate at {len(caught)} of "
            f"{len(readings)} steps")
        if not caught:
            raise AssertionError(f"whisper {ctx.mode}: the logit gate does "
                                 f"not catch the planted fault '{fault}'")
        checks.append(dict(step=f"planted fault: {fault}",
                           rel_l2_err=worst_rel, argmax_agree=worst_agree,
                           steps_caught=len(caught)))
    del plain, got
    torch.cuda.synchronize()
    return checks


def profile_whisper(torch, cfg, ctx, params, batch, prefill_step, loop):
    """Device time by kernel for one whisper prefill and one decode block
    (torch.profiler, the second of two traced rounds)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.api import init_cache_fn
    b, plen = batch["tokens"].shape
    out = {}
    for what in ("prefill", "decode block"):
        for _ in range(2):          # the first traced round starts the tracer
            cache = init_cache_fn(cfg, b, plen + 2 * WHISPER["block"],
                                  torch.float32, "cuda")
            logits, cache = prefill_step(params, batch, cache)
            tok = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]
            pos = torch.full((b,), plen, dtype=torch.int32, device="cuda")
            live = torch.ones((b,), dtype=torch.bool, device="cuda")
            stop = pos + 2 * WHISPER["block"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                if what == "prefill":
                    prefill_step(params, batch, cache)
                else:
                    loop(params, cache, tok, pos, live, stop,
                         {"temperature": torch.zeros((b,), device="cuda"),
                          "top_k": torch.zeros((b,), dtype=torch.int32,
                                               device="cuda")}, None, 0, -1)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = device_rows(prof)
        busy = sum(r[1] for r in rows)
        launches = sum(r[2] for r in rows)
        log(f"[profile] whisper {ctx.mode} {what}: wall {wall * 1e3:.2f} ms, "
            f"device busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), "
            f"{launches} device kernels and copies")
        for k, ms, n in rows[:10]:
            log(f"[profile]   {ms:9.3f} ms  x{n:<5d} {k[:90]}")
        out[what] = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                         device_launches=launches,
                         top=[dict(kernel=k, ms=ms, count=n)
                              for k, ms, n in rows[:25]])
    return out


def device_rows(prof):
    """(kernel, device ms, count) of a torch.profiler run, longest first."""
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0)
        if dev and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((ev.key, dev / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return rows


#: gates of the full-width logit check: relative L2 error, argmax agreement
LOGIT_TOL_REL, LOGIT_MIN_AGREE = 0.25, 0.75


def logit_check(torch, cfg, params, ctx, prompts, batch, max_len, chunk, ps,
                *, steps: int):
    """Full-width logits of one prefill chunk and ``steps`` teacher-forced
    decode steps, in the serving dtype, through the kernels and through
    the plain versions, from the same weights, pages and tables.

    The gates are loose on purpose; the kernels themselves are held
    tightly in phase 3.  int8 activations are re-quantized at every
    projection, so a 1-ulp difference in an attention output (another
    summation order) can move an int8 rounding step; 18 random layers
    carry it on, and each side's KV cache keeps its own such flips (in f32
    compute, where no output rounding hides the ulps, the prefill chunk
    differs more than in bf16).  A broken kernel, stride or scale gives
    errors of order 1 and argmax agreement near 1 / vocab.
    """
    from repro_torch.kernels.flash_attention import _resolve_knobs
    from repro_torch.launch.serve import prepare_params
    from repro_torch.models import lm
    from repro_torch.models.api import set_block_table

    width = -(-(max_len + chunk) // ps)
    t, split = _resolve_knobs(width, ps, 1, batch, None, None)
    ctxs = {name: dataclasses.replace(ctx, kv_split=split, pages_per_step=t,
                                      backend=backend)
            for name, backend in (("kernels", None), ("plain", "ref"))}
    pp = prepare_params(params, ctxs["kernels"], "cuda")
    mode = f"{ctx.mode}{' +lut' if ctx.use_lut else ''}"
    num_pages = batch * (-(-max_len // ps))
    bt = torch.full((batch, width), num_pages, dtype=torch.int32)
    bt[:, :num_pages // batch] = torch.arange(num_pages, dtype=torch.int32) \
        .reshape(batch, -1)
    tokens = torch.tensor(np_stack([p[:chunk] for p in prompts[:batch]]),
                          device="cuda")
    pos = torch.zeros((batch,), dtype=torch.int32, device="cuda")
    caches = {}
    for name in ctxs:
        caches[name] = lm.init_paged_cache(cfg, batch, num_pages, ps, width,
                                           torch.float32, "cuda")
        set_block_table(caches[name], bt.cuda())
    checks = []
    for step in range(steps + 1):
        logits = {}
        for name, c in ctxs.items():
            if step == 0:
                logits[name], _ = lm.prefill(pp, tokens, caches[name], cfg, c,
                                             pos=pos, full_logits=True)
            else:
                logits[name], _ = lm.decode_step(pp, tokens, caches[name],
                                                 pos, cfg, c)
        lp = logits["plain"].float()
        checks.append(gate_logits(
            torch, "[engine]", f"{mode}: " + (
                "prefill chunk" if step == 0 else f"decode step {step}"),
            logits["kernels"].float(), lp, ctx.compute_dtype))
        # teacher forcing: both sides continue from the plain argmax
        pos = pos + tokens.shape[1]
        tokens = lp[:, -1].argmax(-1).to(torch.int32)[:, None]
    del pp, caches
    torch.cuda.synchronize()
    return checks


def logit_readings(lk, lp) -> dict:
    """Relative L2 error, argmax agreement and max abs error of logits
    through the kernels ``lk`` against the plain versions' ``lp``; for
    the rows whose argmax differs, the plain side's top-2 margin (0: an
    exact tie, which any rounding difference decides)."""
    differ = lk.argmax(-1) != lp.argmax(-1)
    top2 = lp[differ].topk(2, dim=-1).values
    return dict(rel_l2_err=((lk - lp).norm() / lp.norm()).item(),
                argmax_agree=(lk.argmax(-1) == lp.argmax(-1)).float()
                .mean().item(),
                flip_margins=(top2[:, 0] - top2[:, 1]).tolist(),
                max_abs_err=(lk - lp).abs().max().item(),
                max_abs_logit=lp.abs().max().item(),
                finite=bool(lk.isfinite().all().item()))


def passes_gate(r: dict, *, tol_rel: float, min_agree: float) -> bool:
    return (r["finite"] and r["rel_l2_err"] <= tol_rel
            and r["argmax_agree"] >= min_agree)


def gate_logits(torch, tag, what, lk, lp, dtype, *,
                tol_rel: float = LOGIT_TOL_REL,
                min_agree: float = LOGIT_MIN_AGREE):
    """Hold logits through the kernels ``lk`` against the plain versions'
    ``lp``: finite, relative L2 error <= ``tol_rel``, argmax agreement
    >= ``min_agree``; log and return the numbers."""
    r = logit_readings(lk, lp)
    log(f"{tag} {what} logits {tuple(lk.shape)}, kernels vs plain "
        f"({str(dtype)[6:]}): relative L2 error {r['rel_l2_err']:.4g} "
        f"(tol {tol_rel}), argmax agreement {r['argmax_agree']:.4f} (tol "
        f"{min_agree}), max_abs_err {r['max_abs_err']:.4g} of max |logit| "
        f"{r['max_abs_logit']:.4g}"
        + (f"; plain top-2 margins of the differing rows "
           f"{[round(x, 4) for x in r['flip_margins'][:8]]}"
           if r["flip_margins"] else ""))
    if not passes_gate(r, tol_rel=tol_rel, min_agree=min_agree):
        raise AssertionError(f"{what} through the kernels disagrees with "
                             f"the plain versions")
    return dict(step=what, rel_l2_err=r["rel_l2_err"], tol_rel=tol_rel,
                max_abs_err=r["max_abs_err"], argmax_agree=r["argmax_agree"],
                flip_margins=r["flip_margins"],
                max_abs_logit=r["max_abs_logit"])


def np_stack(arrs):
    import numpy as np
    return np.stack(arrs).astype(np.int32)


def profile_block(torch, eng, prompts, gen_len):
    """8-step decode blocks of ``eng`` with all lanes live: host time by
    Python function (cProfile, profiler off), then device time by kernel
    (torch.profiler, the second of two traced blocks: the first starts the
    tracer, which took seconds on the card's machine)."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:eng.batch]:
        eng.submit(p, gen_len=gen_len)
    eng.try_admit()
    eng.step_many(8)                 # warm
    torch.cuda.synchronize()
    prof_host = cProfile.Profile()
    t0 = time.perf_counter()
    prof_host.enable()
    eng.step_many(8)
    torch.cuda.synchronize()
    prof_host.disable()
    host_wall = time.perf_counter() - t0
    st = pstats.Stats(prof_host)
    host = sorted(((f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}({fn[2]})", tt * 1e3,
                    nc) for fn, (cc, nc, tt, ct, callers) in st.stats.items()),
                  key=lambda r: -r[1])
    log(f"[profile] host, one 8-step decode block under cProfile: wall "
        f"{host_wall * 1e3:.1f} ms; self time by function:")
    for k, ms, n in host[:15]:
        log(f"[profile]   {ms:9.2f} ms  x{n:<6d} {k[:90]}")
    for _ in range(2):          # the first traced block starts the tracer
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step_many(8)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    log(f"[profile] one 8-step decode block: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), "
        f"{launches} device kernels and copies ({launches / 8:.1f} per "
        f"decode step)")
    for k, ms, n in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{n:<5d} {k[:90]}")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                device_launches=launches,
                top=[dict(kernel=k, ms=ms, count=n) for k, ms, n in rows[:25]],
                host_wall_ms=host_wall * 1e3,
                host_top=[dict(function=k, self_ms=ms, calls=n)
                          for k, ms, n in host[:40]])


#: the redesigned kernels, by their names in ptxas's output (their shared
#: memory is dynamic, sized at launch; ptxas reports the static part): the
#: tensor-core flash kernel, the paged kernel (both routes, one instance
#: per head-dim class), the tensor-core qmatmul (<16, MB> decode, <128, 1>
#: otherwise), the table kernel (<dtype, gated>) and the quantizer's
#: register path (<dtype, threads a row>)
PTXAS_KERNELS = ("flash_attention_bf16_kernel", "paged_attention_kernel",
                 "qmatmul_kernel", "lut_kernel", "quantize_rows_vec_kernel")


def template_args(mangled: str):
    """A kernel's template arguments from their mangled form: ints
    (``Li16E``), bools (``Lb1E``), ``f`` (f32) and ``13__nv_bfloat16``."""
    return [m.group(1) or {"0": "false", "1": "true"}.get(m.group(2))
            or ("bf16" if m.group(0).startswith("13") else "f32")
            for m in re.finditer(r"Li(\d+)E|Lb([01])E|13__nv_bfloat16|f",
                                 mangled)]


def ptxas_summary(build_log) -> dict:
    """Registers, spills, stack and static shared memory of every
    instance of the redesigned kernels, from nvcc's ``-Xptxas -v`` lines;
    logged."""
    out, fn = {}, None
    for info in build_log.values():
        for ln in info["ptxas"]:
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", ln)
            if m:
                fn = m.group(1)
                continue
            hit = fn and next((k for k in PTXAS_KERNELS if k in fn), None)
            if not hit:
                continue
            args = re.search(hit + r"I(.+?E)E", fn)
            key = f"{hit}<" + (",".join(template_args(args.group(1)))
                               if args else "?") + ">"
            row = out.setdefault(key, {})
            for field, pat in (("registers", r"Used (\d+) registers"),
                               ("spill_stores", r"(\d+) bytes spill stores"),
                               ("spill_loads", r"(\d+) bytes spill loads"),
                               ("stack", r"(\d+) bytes stack frame"),
                               ("static_smem", r"(\d+) bytes smem")):
                f = re.search(pat, ln)
                if f:
                    row[field] = int(f.group(1))
    for key, row in sorted(out.items()):
        log(f"[build] ptxas {key}: {row.get('registers')} registers, "
            f"{row.get('spill_stores', 0)} B spill stores, "
            f"{row.get('spill_loads', 0)} B spill loads, "
            f"{row.get('stack', 0)} B stack, static smem "
            f"{row.get('static_smem', 0)} B")
    return out


def kernels_line(rows, counts):
    pick = {"qmatmul": "up/gate M=8 K=2048 N=16384 bfloat16",
            "paged_attention_unsplit": "decode B=8 S=1 tokens~150",
            "paged_attention_split": "decode B=8 S=1 tokens~150",
            "lut_activation": "gelu_gate interp 8x16384 bfloat16",
            "flash_attention": "a whisper-encoder B=8 H=8/8 Sq=1500 "
                               "Skv=1500 D=64 causal=False bf16",
            "lut_gated_mul": "gelu_gate interp 8x16384 bfloat16",
            "quantize_rows": "8x2048 bfloat16"}
    source = {"qmatmul": "src/repro_torch/kernels/csrc/qmatmul.cu",
              "paged_attention_unsplit":
                  "src/repro_torch/kernels/csrc/paged_attention.cu",
              "paged_attention_split":
                  "src/repro_torch/kernels/csrc/paged_attention.cu",
              "lut_activation":
                  "src/repro_torch/kernels/csrc/lut_activation.cu",
              "flash_attention":
                  "src/repro_torch/kernels/csrc/flash_attention.cu",
              "lut_gated_mul":
                  "src/repro_torch/kernels/csrc/lut_activation.cu",
              "quantize_rows":
                  "src/repro_torch/kernels/csrc/quantize_rows.cu"}
    replaces = {"qmatmul": "src/repro/kernels/qmatmul.py:104",
                "paged_attention_unsplit":
                    "src/repro/kernels/flash_attention.py:217",
                "paged_attention_split":
                    "src/repro/kernels/flash_attention.py:514",
                "lut_activation": "src/repro/kernels/lut_activation.py:74",
                "flash_attention": "src/repro/kernels/flash_attention.py:101",
                # the TPU table kernel and the two products XLA applies
                # after it (activations.py:41, blocks.py:72)
                "lut_gated_mul": "src/repro/kernels/lut_activation.py:74",
                # no Pallas kernel: the XLA fusion before every int8 matmul
                "quantize_rows": "src/repro/nn/linear.py:88"}
    out = []
    for name in pick:
        mine = [r for r in rows if r["kernel"] == name]
        rep = next(r for r in mine if r["case"].startswith(pick[name])
                   and "ms" in r)
        out.append(dict(name=name, route="cuda", source=source[name],
                        replaces=replaces[name],
                        launches=counts.get(name, 0),
                        max_abs_err=max(r["max_abs_err"] for r in mine),
                        ms=rep["ms"], plain_ms=rep["plain_ms"],
                        bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
                        library_ms=rep["library_ms"],
                        kernel_over_library=rep.get("kernel_over_library"),
                        shape=rep["case"]))
        if name == "lut_activation":
            out[-1]["library_note"] = ("none (no PyTorch call is a table "
                                       "lookup)")
            out[-1]["context_gelu_tanh_ms"] = rep["gelu_tanh_ms"]
        if name == "lut_gated_mul":
            out[-1]["library_note"] = ("none (no PyTorch call is a table "
                                       "lookup); context: the unfused chain "
                                       "it replaces")
            out[-1]["context_unfused_chain_ms"] = rep["unfused_chain_ms"]
        if name == "quantize_rows":
            out[-1]["library_note"] = ("none (no PyTorch call quantizes); "
                                       "context: torch.amax(x.abs(), 1) on "
                                       "the same bytes")
            out[-1]["context_amax_abs_ms"] = rep["amax_abs_ms"]
        if name == "qmatmul":
            out[-1]["library_note"] = ("none at M 8 (torch._int_mm needs M "
                                       "> 16); context: _int_mm on A padded "
                                       "to M 32, and amax reading B")
            out[-1]["context_int_mm_m32_ms"] = rep["int_mm_m32_ms"]
            out[-1]["context_read_weights_ms"] = rep["read_weights_ms"]
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="phases 1-3 only (build and check the kernels)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one decode block with torch.profiler")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write every check, timing and count as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}

    # 1. build
    t0 = time.perf_counter()
    _cuda.build()
    for name in _cuda.SOURCES:
        _cuda.library(name)
    build_s = time.perf_counter() - t0
    log(f"[build] {len(_cuda.SOURCES)} CUDA sources with nvcc in "
        f"{build_s:.1f}s (parallel)")
    for name, info in _cuda.BUILD_LOG.items():
        for ln in info["ptxas"]:
            log(f"[build]   {name}: {ln.strip()}")
    report["build_s"] = build_s
    report["ptxas"] = ptxas_summary(_cuda.BUILD_LOG)

    # 2. card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[card] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi.splitlines()[0])
    report.update(card=kind, nvidia_smi=smi)

    # 3. kernels vs plain versions
    timer = Timer(torch)
    rows = []
    check_qmatmul(torch, timer, rows)
    torch.cuda.synchronize()
    check_attention(torch, timer, rows)
    torch.cuda.synchronize()
    check_lut(torch, timer, rows)
    torch.cuda.synchronize()
    check_lut_gated(torch, timer, rows)
    torch.cuda.synchronize()
    check_quantize_rows(torch, timer, rows)
    torch.cuda.synchronize()
    check_flash(torch, timer, rows)
    torch.cuda.synchronize()
    check_sampling(torch, timer, report)
    torch.cuda.synchronize()
    check_verify(torch, timer, report)
    torch.cuda.synchronize()
    report["checks"] = rows
    counts = {}
    if not args.kernels:
        # 4. the main path: gemma-2b's four paths, then whisper-base
        del timer
        counts = serve_main_path(torch, report, args.profile)
        torch.cuda.synchronize()
        for k, v in serve_whisper(torch, report, args.profile).items():
            counts[k] = counts.get(k, 0) + v
        torch.cuda.synchronize()
        for k, v in serve_jet(torch, report).items():
            counts[k] = counts.get(k, 0) + v
        torch.cuda.synchronize()

    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    # 5. the last two lines
    log(smi.splitlines()[0])
    print(json.dumps(kernels_line(rows, counts)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
