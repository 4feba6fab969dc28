#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py             # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels   # phases 1-3 only: build and check
    python3 chip_smoke.py --profile   # also trace one decode block
    python3 chip_smoke.py --report out.json   # also write every number

Phases, one line each, any failure raises and the exit code is non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and print ``ptxas`` usage;
2. print the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
3. hold every kernel against its plain PyTorch version on the card at the
   main path's shapes (gemma-2b at full width: qmatmul at M = 8 and 128
   over every projection, paged attention at decode and prefill, unsplit
   and split, plus a ~4096-token decode, lut_activation on one layer's
   gate activations at decode and prefill with every indexing and the
   gelu, silu and softmax-exp tables), with the kernel's, the plain
   version's and a library call's device time (median of cold-L2
   launches, CUDA events) beside the least time the card could take;
4. serve full-width gemma-2b, bf16 compute, batch 8, prompt 128, gen 32,
   on four paths, each with the launch counters reset just before it and
   read just after, failing if a kernel of the path never launched:
   int8 weights on the paged f32 KV cache (16 requests at the auto knobs,
   then 8 at ``kv_split=1``); ``--lut --paged`` with bf16 weights (every
   gated GELU through the lut_activation kernel, 18 launches per model
   call); ``--quant int8 --lut --kv-bits 8`` on the dense cache (the
   fused table epilogue, int8 KV rows, the table softmax).  Logits of one
   prefill chunk and 4 decode steps through the kernels are compared with
   the plain versions' on the int8 paged and the LUT paged configurations;
5. print the kernels line, then the device line last.

Weights are random (seeded ``torch.Generator`` on the card), quantized by
the port's own ``ptq_params``; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_qmatmul(torch, timer, rows):
    from repro_torch.core.tables import TableSpec, get_table
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_plain
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [(m, name, k, n, torch.bfloat16, None)
             for m in (8, 128) for name, k, n in GEMMA_PROJ]
    cases.append((128, "wq f32", 2048, 2048, torch.float32, None))
    # the fused epilogue: bias + gated gelu table (step 2^-6), and silu's
    # gate table, whose step 20/1024 is not a power of two (both the
    # kernel and its plain version index with (y - lo) * step_inv)
    cases.append((128, "up+bias+lut", 2048, 2048, torch.float32,
                  TableSpec("gelu_gate", 1024, -8.0, 8.0, None, "interp")))
    cases.append((8, "up+bias+silu-lut", 2048, 16384, torch.bfloat16,
                  TableSpec("silu_gate", 1024, -10.0, 10.0, None,
                            "interp")))
    for m, name, k, n, out_dtype, spec in cases:
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        sa = (torch.rand((m, 1), generator=g, device="cuda") + 0.1) * 1e-3
        sb = (torch.rand((1, n), generator=g, device="cuda") + 0.1) * 1e-3
        bias = (torch.randn((n,), generator=g, device="cuda")
                if spec is not None else None)
        kw = dict(act_spec=spec, act_gated=spec is not None)
        got = qmatmul(a, b, sa, sb, bias, out_dtype, **kw)
        want = qmatmul_plain(a, b, sa, sb, bias, out_dtype, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        # exact int32 accumulation and the reference's epilogue op order:
        # equal up to one rounding of the output type at the largest value
        tol = scale * (2.0 ** -8 if out_dtype == torch.bfloat16 else 1e-6)
        if not (err <= tol and torch.isfinite(got).all().item()):
            raise AssertionError(f"qmatmul {name} M={m}: max_abs_err {err} "
                                 f"> tol {tol}")
        ms = timer(lambda: qmatmul(a, b, sa, sb, bias, out_dtype, **kw))
        plain_ms = timer(lambda: qmatmul_plain(a, b, sa, sb, bias, out_dtype,
                                               **kw), reps=5)
        lib_ms = None
        if m > 16 and spec is None:       # torch._int_mm needs M > 16
            lib_ms = yardstick(timer, lambda: torch._int_mm(a, b))
        out_bytes = 2 if out_dtype == torch.bfloat16 else 4
        nbytes = m * k + k * n + 4 * m + 4 * n + out_bytes * m * n
        if spec is not None:
            nbytes += 4 * n + 4 * get_table(spec).np_values.size
        bnd, by = bound_ms(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
        rows.append(dict(kernel="qmatmul", case=f"{name} M={m} K={k} N={n} "
                         f"{str(out_dtype)[6:]}", max_abs_err=err, tol=tol,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bnd, bound_by=by))
        log(f"[check] qmatmul {rows[-1]['case']}: max_abs_err={err:.3g} "
            f"(tol {tol:.3g}) kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
            f"library={fmt_ms(lib_ms)} "
            f"bound={bnd:.4f}ms ({by})")


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
                    # f32 exact: the same single-rounded operations; bf16
                    # within one rounding of the output type at the largest
                    # value
                    tol = (want.float().abs().max().item() * 2.0 ** -8
                           if dt == torch.bfloat16 else 0.0)
                    if not (err <= tol and torch.isfinite(got).all().item()):
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
                        f"library=none (context: F.gelu tanh "
                        f"{gelu_ms:.4f}ms) bound={bnd:.5f}ms ({by})")


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
                       f"bound={row['bound_ms']:.4f}ms ({row['bound_by']})"
                       if "ms" in row else ""))


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


def run_path(torch, label, eng, prompts, gen_len, expect):
    """Drive one path through the engine's entry points: the launch counts
    are set to 0 just before and read just after; every kernel named in
    ``expect`` must have launched.  Returns (run summary, counts)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.lifecycle import RequestStatus
    reset_launch_counts()
    t1 = time.perf_counter()
    ids = [eng.submit(p, gen_len=gen_len) for p in prompts]
    eng.try_admit()
    blocks = 0
    while eng.live.any() or eng.waiting:
        eng.step_many(8)
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
    run = dict(requests=len(ids), paged=eng.paged, kv_bits=eng.kv_bits,
               lut=eng.ctx.use_lut, quant=eng.ctx.mode,
               kv_split=eng.kv_split, pages_per_step=eng.pages_per_step,
               ttft_mean_s=st["ttft_mean_s"],
               decode_tok_per_s=st["decode_tok_per_s"], decode_s=st["decode_s"],
               gen_tokens=st["gen_tokens"], decode_steps=st["decode_steps"],
               prefill_chunks=st["prefill_chunks"], blocks=blocks,
               wall_s=wall, launches=counts,
               streams=[eng.results[i]["tokens"] for i in ids])
    cache = (f"paged, knobs (pages_per_step={eng.pages_per_step}, "
             f"kv_split={eng.kv_split})" if eng.paged else "dense")
    log(f"[engine] {label}: served {len(ids)} requests x {gen_len} tokens "
        f"in {wall:.2f}s, {cache}, TTFT mean {st['ttft_mean_s']:.4f}s, "
        f"decode {st['decode_tok_per_s']:.1f} tok/s over {blocks} blocks "
        f"({st['decode_steps']} decode steps, {st['prefill_chunks']} prefill "
        f"chunks); kernel launches {json.dumps(counts)}")
    return run, counts


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
        record(label, *run_path(torch, label, eng, reqs, gen_len, expect))
    first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       None)
                  for a, b in zip(runs["int8 paged, auto knobs"]["streams"],
                                  runs["int8 paged, kv_split=1"]["streams"])]
    log(f"[engine] split vs unsplit kernel streams, first differing token per "
        f"request (None = identical): {first_diff} (bf16 logits of random "
        f"weights are full of near-ties; association order flips them)")
    rows_out["split_vs_unsplit_first_diff"] = first_diff

    # -- regime (c): int8 weights + tables on the dense cache, int8 KV rows
    label = "int8 --lut --kv-bits 8, dense"
    lut8 = dataclasses.replace(int8, use_lut=True)
    eng = engines[label] = Engine(cfg, lut8, params, kv_bits=8, **geometry)
    run, counts = run_path(torch, label, eng, prompts[:batch], gen_len,
                           ("qmatmul",))
    if counts["lut_activation"] != 0:
        raise AssertionError(f"{label}: the table belongs in qmatmul's "
                             f"epilogue, yet lut_activation launched")
    record(label, run, counts)

    # -- regime (a): bf16 weights, every gated GELU through lut_activation -
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
                           ("lut_activation", "paged_attention_split"))
    want = cfg.n_layers * (run["decode_steps"] + run["prefill_chunks"])
    if counts["lut_activation"] != want or counts["qmatmul"] != 0:
        raise AssertionError(
            f"{label}: lut_activation launched {counts['lut_activation']} "
            f"times, expected {cfg.n_layers} layers x ({run['decode_steps']} "
            f"decode steps + {run['prefill_chunks']} prefill chunks) = {want}"
            f"; qmatmul {counts['qmatmul']} (expected 0)")
    record(label, run, counts)

    for r in runs.values():
        r.pop("streams")
    rows_out["serving"] = runs
    rows_out["launches"] = total
    log(f"[engine] main-path launches over all paths: {json.dumps(total)}")

    if profile:
        # an optional diagnostic, after every phase has passed: a profiler
        # that cannot trace this machine is reported, not fatal
        rows_out["profile"] = {}
        for label, eng in engines.items():
            if label == "int8 paged, kv_split=1":
                continue
            log(f"[profile] {label}")
            try:
                rows_out["profile"][label] = profile_block(torch, eng,
                                                           prompts, gen_len)
            except (RuntimeError, AttributeError) as e:
                log(f"[profile] failed: {e!r}")
    return total


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
        lk, lp = logits["kernels"].float(), logits["plain"].float()
        rel = ((lk - lp).norm() / lp.norm()).item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        err = (lk - lp).abs().max().item()
        what = (f"{mode}: " + ("prefill chunk" if step == 0
                               else f"decode step {step}"))
        log(f"[engine] {what} logits {tuple(lk.shape)}, kernels vs plain "
            f"({str(ctx.compute_dtype)[6:]}): relative L2 error {rel:.4g} "
            f"(tol {LOGIT_TOL_REL}), argmax agreement {agree:.4f} (tol "
            f"{LOGIT_MIN_AGREE}), max_abs_err {err:.4g} of max |logit| "
            f"{lp.abs().max().item():.4g}")
        if not (torch.isfinite(lk).all().item() and rel <= LOGIT_TOL_REL
                and agree >= LOGIT_MIN_AGREE):
            raise AssertionError(f"{what} through the kernels disagrees with "
                                 f"the plain versions")
        checks.append(dict(step=what, rel_l2_err=rel, tol_rel=LOGIT_TOL_REL,
                           max_abs_err=err, argmax_agree=agree,
                           max_abs_logit=lp.abs().max().item()))
        # teacher forcing: both sides continue from the plain argmax
        pos = pos + tokens.shape[1]
        tokens = lp[:, -1].argmax(-1).to(torch.int32)[:, None]
    del pp, caches
    torch.cuda.synchronize()
    return checks


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
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0)
        if dev and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((ev.key, dev / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[profile] one 8-step decode block: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%)")
    for k, ms, n in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{n:<5d} {k[:90]}")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                top=[dict(kernel=k, ms=ms, count=n) for k, ms, n in rows[:25]],
                host_wall_ms=host_wall * 1e3,
                host_top=[dict(function=k, self_ms=ms, calls=n)
                          for k, ms, n in host[:40]])


def kernels_line(rows, counts):
    pick = {"qmatmul": "up/gate M=8 K=2048 N=16384 bfloat16",
            "paged_attention_unsplit": "decode B=8 S=1 tokens~150",
            "paged_attention_split": "decode B=8 S=1 tokens~150",
            "lut_activation": "gelu_gate interp 8x16384 bfloat16"}
    source = {"qmatmul": "src/repro_torch/kernels/csrc/qmatmul.cu",
              "paged_attention_unsplit":
                  "src/repro_torch/kernels/csrc/paged_attention.cu",
              "paged_attention_split":
                  "src/repro_torch/kernels/csrc/paged_attention.cu",
              "lut_activation":
                  "src/repro_torch/kernels/csrc/lut_activation.cu"}
    replaces = {"qmatmul": "src/repro/kernels/qmatmul.py:104",
                "paged_attention_unsplit":
                    "src/repro/kernels/flash_attention.py:217",
                "paged_attention_split":
                    "src/repro/kernels/flash_attention.py:514",
                "lut_activation": "src/repro/kernels/lut_activation.py:74"}
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
                        library_ms=rep["library_ms"], shape=rep["case"]))
        if name == "lut_activation":
            out[-1]["library_note"] = ("none (no PyTorch call is a table "
                                       "lookup)")
            out[-1]["context_gelu_tanh_ms"] = rep["gelu_tanh_ms"]
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
    report["checks"] = rows
    counts = {}
    if not args.kernels:
        # 4. the main path
        del timer
        counts = serve_main_path(torch, report, args.profile)
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
