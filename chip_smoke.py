#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py             # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels   # phases 1-3 only: build and check
    python3 chip_smoke.py --profile   # also trace one decode block
    python3 chip_smoke.py --report out.json   # also write every number

Phases, one line each, any failure raises and the exit code is non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and print ``ptxas`` usage, with
   a summary of the tensor-core flash, paged (both routes), qmatmul (the
   TMA weight-stream, wgmma and narrow wgmma instances and the parent
   kernel), table, quantizer and flash backward instances;
2. print the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
3. hold every kernel against its plain PyTorch version on the card at the
   main path's shapes (gemma-2b at full width: qmatmul at M = 8 and 128
   over every projection, at a verify pass's M = 40 and at the
   instances' edge M = 64 / 65 (each case's plan logged, the parent
   kernel run and timed beside it, bitwise), over
   whisper-base's at M = 8, 128 and 12000 with and without a bias, and
   over the jet MLP's four layers at M = 1, 128 and 16384, over the
   rest of the lm family's projections (the untied heads at N = vocab,
   command-r's MLP, glm4's q/k/v with bias, deepseek's MLA), and over
   mamba2's and zamba2's at M = 8 and 128 (N 4384 and 8384: the N
   tail), and over llama-3.2-vision's at M = 8, 512 (up/gate) and 8 x
   1601 (the image's K/V), all bitwise;
   paged attention at decode, verify (S = 5) and prefill, unsplit
   and split, plus a ~4096-token decode, and at D 128 with query groups
   of 8, 16 and 1 (path 10's heads), and zamba2's 32 heads at D 64
   (group 1), decode and verify, each on the Hopper kernel (its plan
   logged) and on the control (the first port's kernel) beside it, both
   held to the gate and timed; lut_activation on olmoe's experts'
   gate activations (8 x 64 x cap x 1024), on path 11's f32 softplus
   and silu rows, and on one layer's
   gate activations at decode and prefill with every indexing and the
   gelu, silu and softmax-exp tables; lut_gated_mul (the gated MLP's
   table pass) on the same shapes and path 12's SiLU at 8 x 14336,
   bitwise, beside the unfused chain it replaces; quantize_rows at
   gemma-2b's decode and prefill rows, whisper-base's 12000 encoder rows
   and path 12's 12808 image rows, bitwise with zero, half-way and NaN
   rows; flash_attention at the whisper
   encoder's shape, gemma-2b's cache-free prefill, ragged Sq/Skv, the
   MLA width, glm4's S 512, deepseek's S 512 naive MLA form (128 heads,
   D 192, V padded from 128), zamba2's forward (B 8, 32 heads, S 512,
   D 64) and path 12's (B 4, 32 heads on 8, S 512, D 128), bf16 and
   f32), with the kernel's, the plain
   version's and a
   library call's device time (median of cold-L2 launches, CUDA events)
   and the kernel/library factor beside the least time the card could
   take; then the flash backward (``flash_attention_bwd``, training's
   gradient, its kernels in one launch) against its plain version at
   gemma-2b's training shape (B 8, 8 on 1 heads, S 256, D 256, causal,
   bf16 and f32) and at path 14's microbatch (B 4), the whisper encoder's, glm4's group of 16, deepseek's
   MLA (V padded) and a ragged causal shape: dq, dk, dv within relative
   L2 1e-5 (f32) or 1e-4 (bf16, which a control that rounds p and ds to
   bf16 before their products must fail), bitwise across two launches, the forward's lse against the plain log-sum-exp and its
   output with lse bitwise the output without, SDPA's backward as the
   yardstick; then sampling (PyTorch ops, no kernel of the port) at (8,
   256000): bitwise its plain version on the card, threefry bits bitwise
   the CPU's, its device time from a CUDA graph replay and its device
   kernels per call; likewise ``verify_tokens_fused`` (speculative
   decoding's acceptance rule) at (8, 5, 256000); the backward kernels
   of training under --lut and --quant int8 at gemma-2b's training
   shapes (2048 tokens): lut_gated_mul_bwd and lut_activation_bwd over
   (2048, 16384), every indexing, bf16 and f32, bitwise; quantize_rows_bwd
   over K 2048 and 16384 with ties, zero and floor rows, bitwise;
   qmatmul_bwd over every projection (the gate also with the gated GELU
   epilogue, one with a bias) within QMM_BWD_TOL of the plain version
   and bitwise across launches;
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
   the self-drafter on the dense target cache, and the
   n-gram drafter with half the lanes sampled; greedy streams held
   against the plain Engine on the same prompts and cache (identical, or
   parting only where the plain Engine's own top-2 margin is below 1e-3),
   graphed == eager, blocks of 2 + 3 rounds == 5, the chain drafter
   accepting >= 3 of 4 drafts a round; accepted drafts, committed tokens
   per verify pass, wall per committed token and device busy per round
   logged.  Path 7: the jet-tagging MLP at batch 1 and 16384, f32, int8
   PTQ and int8 with the table softmax, the int8 outputs bitwise the
   plain versions', eager and graphed time per batch beside its bound.
   Path 8: path 1's configuration on 16 requests that share a 96-token
   system prompt (32 tokens of their own, 32 generated): plain; with the
   prefix cache (the second wave hits 6 pages and prefills 32 tokens);
   with preempt-and-spill over a pool of 70% of 8 lanes' budgets; and
   under a fault schedule (raise, nan, corrupt, slow) with recovery:
   each run's streams held against the plain run's as path 6's are,
   hits, preemptions, replays and the flagged slow block required, no
   graph captured again by recovery; prefill tokens and ms, TTFT of each
   wave, wall per step, spill and resume ms per page, snapshot and
   restore ms a block logged.
   Path 9: path 1's configuration on 16 requests of mixed priority
   classes: a durable run (journal and snapshots every 2 blocks) and two
   crashes (after a durable snapshot; before any) recovered into fresh
   Engines, bitwise the durable run's streams and ``done`` order; the
   autotuner (``analytic`` gives ``off``'s knobs and streams and
   ``decode_block`` 32; ``fitted`` from the port's H100 artifact, or a
   short calibration sweep here, bitwise an ``off`` Engine at the same
   knobs, where it parts from analytic's logged; the adaptive ``spec_k``
   on the n-gram run equal to fixed k); two replicas and a hot standby
   (fault-free with no death; the primary killed: one promotion,
   bitwise; the secondary killed: re-dispatched once, gated as path 6),
   device busy of a fleet round against one Engine's; a batch flood
   against a realtime floor (admitted while the flood runs, no class over
   its cap); journal, snapshot, recovery and promotion times and memory
   on the card after every rebuild logged.
   Path 10: yi-6b, glm4-9b, command-r-35b, olmoe-1b-7b and
   deepseek-v2-236b at their published widths, 2 layers each (deepseek:
   its dense first layer and one MoE layer), int8 weights, paged f32 KV,
   batch 8, 8 requests, prompt 128, chunk 16, page 16, 16 greedy tokens,
   graphed: every request completes, qmatmul and quantize_rows launch,
   paged attention on the GQA configs and never on deepseek (its absorbed
   decode attends with einsums), logits held as path 1's; prefill ms per
   chunk, decode wall, device busy and kernels per step and peak memory
   logged; a cache-free forward at S 512 of glm4 and deepseek (flash once
   per layer, gated), deepseek in blocks of 4, 8, 4 (two graphs, one
   memory pool) and eager, identical, olmoe under ``--lut
   --paged`` with bf16 weights (lut_activation once per MoE layer and
   model call); olmoe and deepseek also with greedy n-gram speculation
   (spec_k 4, graphed), gated against their plain streams as path 6's.
   Path 11: the recurrent families, mamba2-370m (48 layers) and
   zamba2-1.2b (38 mamba layers and the shared block every 6) at full
   width and depth, batch 8, 8 requests, prompt 64 (the looped prefill:
   one full-batch decode step per prompt token), 32 greedy tokens,
   graphed blocks of 8: (a) mamba2 int8 on the dense state, (b) zamba2
   int8 on the paged KV (auto knobs), each admitted once and snapshotted,
   the snapshot restored into an eager engine (identical streams and
   counts) and into speculative ones (d: n-gram, and a chain drafter
   proposing (a)/(b)'s streams, >= 3 of 4 accepted; gated as path 6's),
   (e) zamba2 with
   preempt-and-spill over 70% of the pages (gated as path 6's), (c) both
   under ``--lut`` with bf16 weights (zamba2 paged), (f) mamba2's
   whole-prompt prefill through the step builders and zamba2's cache-free
   forward at B 8, S 512 (flash once per application point); logits of
   a whole-prompt prefill and 4 decode steps gated as path 1's; the
   launch counts required per run (paged attention on zamba2 and never
   on mamba2, one graph per (steps, sampled)); looped prefill ms per
   admission, decode wall, device busy and kernels per step, state bytes
   per lane, peak memory, spill and resume ms and the device time of the
   SSD scan and the decode-state update (PyTorch ops: the reference has
   no kernel for them) logged.
   Path 12: llama-3.2-vision-11b (the vlm family: 8 groups of 4 self
   layers and a gated cross layer, 1601 image tokens) at full width and
   depth through the serving step builders (the Engine refuses the
   family: the reference Engine never passes the image), the gates drawn
   nonzero, bf16 compute, the dense f32 KV cache, batch 8, prompt 64 and
   the stub image, 32 greedy tokens in graphed blocks of 8: (a) int8
   weights, (b) bf16 weights under --lut, (c) (a)'s cache-free forward
   at B 4, S 512 with the image; logits of the prefill and 4 decode
   steps gated as path 1's and, on (a), bitwise (relative L2 <= 1e-4),
   which a zeroed image and two groups' swapped cross K/V must fail;
   exact launch counts (qmatmul 280 a prefill and 264 a decode step,
   one quantize_rows each; lut_gated_mul 40 a call; flash 32 in (c));
   graphed == eager, one capture serving two prefills; prefill ms (the
   image projection apart), decode wall, busy and kernels per step,
   cross K/V bytes and peak memory logged;
   Path 13: the paper's training (``train_path``, ``[train]`` lines):
   (a) gemma-2b at published width and full depth (2.51 B parameters,
   f32 params and AdamW state, bf16 compute, remat "full") through
   ``init_state`` and ``build_train_step``, batch 8 x 256 tokens, 6
   steps; step 0's gradients through the kernels held leaf by leaf
   against the plain versions' (``backend="ref"``) within
   ``TRAIN_GRAD_TOL``, which a zeroed dk and a dv one key off must fail;
   finite losses, and step 0's batch scoring lower after the 6 steps than
   at step 0; wall, busy, tokens/s, the share of bf16
   peak, device time by kernel, flash launches a step, peak memory; (b)
   ``launch.train.main`` at smoke width: a fault at step 5 restored from
   a checkpoint ends bitwise on the unfailed run, and ``--quant fake``
   trains; (c) the jet example's flow on the card within 0.01 of the
   CPU's; (d) ``train_quant_path``: gemma-2b at full width and depth
   under --quant int8 --lut, bf16, 3 steps: step 0's gradients held
   against the plain versions' (the attention on the flash kernels on
   both sides) within TRAIN_GRAD_TOL, which the table slope one entry off
   and a zeroed b_scale gradient must fail; 126 qmatmul_bwd and
   quantize_rows_bwd launches a step; wall, busy, tokens/s, peak memory;
   one gradient each of gemma-2b under --lut (lut_gated_mul_bwd once a
   layer) and mamba2-370m under --lut at full depth (lut_activation_bwd
   three times a layer), gated alike;
   Path 14: the sharded trainer (``dist_train_path``, ``[dist]``
   lines): a one-rank NCCL group and ``make_local_mesh(model=1)``;
   gemma-2b at full width and depth with path 13 (a)'s settings, 3 steps
   at microbatches 2 with ``grad_specs``, without and with the mesh: the
   sharded step-0 gradients and losses bitwise the unsharded ones (one
   rank runs the same kernels on the same rows), a planted fault (the
   second microbatch's loss scaled by 1.01) failing that gate, the flash
   kernels launched, NCCL on the card; wall, busy and peak memory beside
   path 13's; (e) a smoke checkpoint saved from the mesh restores and
   replays bitwise;
5. print the kernels line, then the device line last.

Weights are random (seeded ``torch.Generator`` on the card), quantized by
the port's own ``ptq_params``; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
#: the rest of the lm family's int8 projections (path 10): the untied
#: heads at N = vocab, command-r's MLP, glm4's q/k/v with their bias and
#: deepseek's MLA projections; (name, K, N, bias)
FAMILY_PROJ = [("yi head", 4096, 64000, False),
               ("glm4 head", 4096, 151552, False),
               ("deepseek head", 5120, 102400, False),
               ("olmoe head", 2048, 50304, False),
               ("command-r up/gate", 8192, 22528, False),
               ("command-r down", 22528, 8192, False),
               ("glm4 wq+bias", 4096, 4096, True),
               ("glm4 wk/wv+bias", 4096, 256, True),
               ("mla wq_a", 5120, 1536, False),
               ("mla wq_b", 1536, 24576, False),
               ("mla wkv_a", 5120, 576, False),
               ("mla wo", 16384, 5120, False)]
#: the recurrent families' int8 projections (path 11): mamba2-370m's and
#: zamba2-1.2b's in/out projections (N 4384 and 8384 test the N tail) and
#: zamba2's shared block; (name, K, N)
RECURRENT_PROJ = [("mamba2 in_proj", 1024, 4384), ("mamba2 out_proj", 2048, 1024),
                  ("zamba2 in_proj", 2048, 8384),
                  ("zamba2 out_proj", 4096, 2048),
                  ("zamba2 shared q/k/v/o", 2048, 2048),
                  ("zamba2 shared up/gate", 2048, 8192),
                  ("zamba2 shared down", 8192, 2048)]
#: llama-3.2-vision-11b's int8 projections (path 12) at a decode step's 8
#: rows: q/o, k/v (8 KV heads of 128), the gated MLP's gate/up and down
VLM_PROJ = [("vlm wq/wo", 4096, 4096), ("vlm wk/wv", 4096, 1024),
            ("vlm up/gate", 4096, 14336), ("vlm down", 14336, 4096)]
#: path 12's image: 1601 patch tokens a sample, batch 8 (the rows of the
#: image's K/V projections at prefill)
VLM_IMG_ROWS = 8 * 1601
#: speculative decoding's draft depth on path 6: a verify pass runs the
#: model at M = 8 x (SPEC_K + 1) = 40 rows and paged attention at S = 5
SPEC_K = 4


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Device time of one call with a cold L2: a 256 MB read before each
    launch flushes the L2 and leaves it clean (a flush by a write left
    dirty lines that the timed call wrote back: PERF.md section 6); a
    spin kernel keeps the card busy while the host enqueues the call, so
    host overhead is not timed; CUDA events bracket it.  The spin lasts
    1M cycles, or longer where a warm call takes the host longer than
    half of that to enqueue (a host-heavy call, such as autograd's)."""

    #: the spin's cycles a second (the H100's top SM clock, 1.98 GHz)
    SPIN_HZ = 1.98e9

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")

    def __call__(self, fn, reps: int = 15) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        spin = max(1_000_000, int(2 * host * self.SPIN_HZ))
        pairs = []
        for _ in range(reps):
            self.flush.amax()
            torch.cuda._sleep(spin)
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


def qmatmul_cases():
    """Phase 3's qmatmul cases: (M, name, K, N, output type, epilogue
    table or None, bias), from the model constants alone (the plan's CPU
    test reads them too)."""
    bf, f32 = "bfloat16", "float32"
    cases = [(m, name, k, n, bf, None, False)
             for m in (8, 128) for name, k, n in GEMMA_PROJ]
    cases.append((128, "wq f32", 2048, 2048, f32, None, False))
    cases.append((128, "up+bias+lut", 2048, 2048, f32, "gelu", True))
    cases.append((8, "up+bias+silu-lut", 2048, 16384, bf, "silu", True))
    # whisper-base's projections, without and with a bias (the epilogue's
    # fma(acc * sa, sb, bias))
    cases += [(m, f"whisper {name}{'+bias' if bias else ''}", k, n, bf,
               None, bias)
              for m in (8, 128, 12000) for name, k, n in WHISPER_PROJ
              for bias in (False, True)]
    # a speculative verify pass (path 6): 8 lanes x (k + 1) rows; the
    # weight-stream instance's last row count (64) and the wide
    # instance's first (65)
    cases += [(m, f"{'verify ' if m == 8 * (SPEC_K + 1) else ''}{name}",
               k, n, bf, None, False)
              for m in (8 * (SPEC_K + 1), 64, 65) for name, k, n in GEMMA_PROJ]
    # the jet MLP's layers (path 7), f32 out with the bias epilogue
    cases += [(m, f"jet {name}", k, n, f32, None, True)
              for m in (1, 128, 16384) for name, k, n in JET_PROJ]
    # path 10: a decode step's 8 rows everywhere, a prefill chunk's 128
    # on the heads
    cases += [(m, name, k, n, bf, None, bias)
              for name, k, n, bias in FAMILY_PROJ
              for m in ((8, 128) if "head" in name else (8,))]
    # path 11: a decode step's 8 rows and 128
    cases += [(m, name, k, n, bf, None, False)
              for name, k, n in RECURRENT_PROJ for m in (8, 128)]
    # path 12: a decode step's 8 rows, the prefill prompt's 8 x 64 on the
    # MLP's up/gate, the image's 8 x 1601 rows on its K/V
    cases += [(8, name, k, n, bf, None, False) for name, k, n in VLM_PROJ]
    cases += [(512, "vlm prefill up/gate", 4096, 14336, bf, None, False),
              (VLM_IMG_ROWS, "vlm image wk/wv", 4096, 1024, bf, None, False)]
    return cases


def qmm_plan_name(plan) -> str:
    """A qmatmul plan in a few words: instance, block tile (weight columns
    x token rows), split, ring stages."""
    return (f"{plan.instance} {plan.cols}x{plan.rows} split {plan.splits} "
            f"ring {plan.stages}")


def check_qmatmul(torch, timer, rows):
    """qmatmul at every phase-3 case: the planned instance and the
    parent kernel (the control instance) both bitwise the plain version,
    each timed; the plan logged beside its time."""
    from repro_torch.core.tables import TableSpec, get_table
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.qmatmul import (qmatmul, qmatmul_plain,
                                             qmatmul_plan)
    sms = _cuda.sm_count(torch.device("cuda", 0))
    g = torch.Generator(device="cuda").manual_seed(1)
    # the fused epilogue's tables: bias + gated gelu (step 2^-6), and
    # silu's gate, whose step 20/1024 is not a power of two (both the
    # kernel and its plain version index with (y - lo) * step_inv)
    tables = {"gelu": TableSpec("gelu_gate", 1024, -8.0, 8.0, None,
                                "interp"),
              "silu": TableSpec("silu_gate", 1024, -10.0, 10.0, None,
                                "interp")}
    cases = [(m, name, k, n, getattr(torch, out), tables.get(table), bias)
             for m, name, k, n, out, table, bias in qmatmul_cases()]
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
        plan = qmatmul_plan(m, n, k, sms)
        control = qmatmul_plan(m, n, k, sms, "control")
        got = qmatmul(a, b, sa, sb, bias, out_dtype, **kw)
        got_parent = qmatmul(a, b, sa, sb, bias, out_dtype, plan=control,
                             **kw)
        want = qmatmul_plain(a, b, sa, sb, bias, out_dtype, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # exact int32 accumulation and the same single-rounded epilogue
        # operations in the same order: bitwise equal, and bitwise the
        # parent kernel's output (the control instance)
        tol = 0.0
        if not (err <= tol and torch.isfinite(got).all().item()
                and same_raw_bits(torch, got, got_parent)):
            raise AssertionError(f"qmatmul {name} M={m} "
                                 f"({qmm_plan_name(plan)}): max_abs_err "
                                 f"{err} > tol {tol}, or not bitwise the "
                                 f"parent kernel")
        ms = timer(lambda: qmatmul(a, b, sa, sb, bias, out_dtype, **kw))
        parent_ms = (ms if plan == control else timer(
            lambda: qmatmul(a, b, sa, sb, bias, out_dtype, plan=control,
                            **kw)))
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
                         bound_ms=bnd, bound_by=by,
                         plan=qmm_plan_name(plan), parent_ms=parent_ms,
                         bitwise_parent=True))
        log(f"[check] qmatmul {rows[-1]['case']}: [{qmm_plan_name(plan)}] "
            f"max_abs_err={err:.3g} (tol {tol:.3g}), bitwise the parent "
            f"kernel; kernel={ms:.4f}ms parent={parent_ms:.4f}ms "
            f"plain={plain_ms:.4f}ms library={fmt_ms(lib_ms)} "
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
    # path 10: olmoe's experts' SiLU under --lut with float weights (act_fn
    # on the (B, E, cap, F) gate activations): a decode step's 8 x 64
    # expert rows of 1024, and a prefill chunk's capacity of 8
    spec = TableSpec("silu_gate", 1024, -10.0, 10.0, None, "interp")
    for cap in (1, 8):
        x = (torch.randn((8, 64, cap, 1024), generator=g, device="cuda")
             * 4).to(torch.bfloat16)
        got, want = lut_activation(x, spec), lut_activation_plain(x, spec)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not (torch.equal(got, want) and torch.isfinite(got).all().item()):
            raise AssertionError(f"lut_activation olmoe experts cap {cap}: "
                                 f"max_abs_err {err} > tol 0")
        ms = timer(lambda: lut_activation(x, spec))
        plain_ms = timer(lambda: lut_activation_plain(x, spec), reps=5)
        silu_ms = timer(lambda: F.silu(x))
        bnd, by = bound_ms(2 * x.numel() * 2 + 4 * spec.n, 10.0 * x.numel(),
                           F32_FLOP_PER_S)
        rows.append(dict(kernel="lut_activation",
                         case=f"olmoe experts silu_gate interp 8x64x{cap}x1024"
                         f" bfloat16", max_abs_err=err, tol=0.0, ms=ms,
                         plain_ms=plain_ms, library_ms=None,
                         silu_ms=silu_ms, bound_ms=bnd, bound_by=by))
        log(f"[check] lut_activation {rows[-1]['case']}: max_abs_err="
            f"{err:.3g} (tol 0) kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
            f"library=none kernel/library={over_library(rows[-1])} "
            f"(context: F.silu {silu_ms:.4f}ms) bound={bnd:.5f}ms ({by})")
    # path 11 under --lut: a decode step's f32 softplus on dt (8 lanes x
    # heads) and silu on the conv output (conv_dim) and on the gate
    # (d_inner), mamba2's and zamba2's
    for fn, lo, hi, cols in (("softplus", -16.0, 16.0, (32, 64)),
                             ("silu_gate", -10.0, 10.0,
                              (2304, 4224, 2048, 4096))):
        spec = TableSpec(fn, 1024, lo, hi, None, "interp")
        for n in cols:
            x = torch.randn((8, n), generator=g, device="cuda") * 4
            got, want = lut_activation(x, spec), lut_activation_plain(x, spec)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not (torch.equal(got, want) and torch.isfinite(got).all()
                    .item()):
                raise AssertionError(f"lut_activation {fn} 8x{n} float32: "
                                     f"max_abs_err {err} > tol 0")
            ms = timer(lambda: lut_activation(x, spec))
            plain_ms = timer(lambda: lut_activation_plain(x, spec), reps=5)
            bnd, by = bound_ms(2 * x.numel() * 4 + 4 * spec.n,
                               10.0 * x.numel(), F32_FLOP_PER_S)
            rows.append(dict(kernel="lut_activation",
                             case=f"recurrent {fn} interp 8x{n} float32",
                             max_abs_err=err, tol=0.0, ms=ms,
                             plain_ms=plain_ms, library_ms=None,
                             bound_ms=bnd, bound_by=by))
            log(f"[check] lut_activation {rows[-1]['case']}: max_abs_err="
                f"{err:.3g} (tol 0) kernel={ms:.4f}ms plain="
                f"{plain_ms:.4f}ms library=none bound={bnd:.5f}ms ({by})")


def check_lut_gated(torch, timer, rows):
    """lut_gated_mul (the gated MLP's table pass) against its plain
    version on one layer's gate and up activations, (tokens, d_ff) = (8,
    16384) at decode and (128, 16384) for a prefill chunk, bf16 and f32,
    every indexing, the gated GELU table (the main path's) and silu's gate
    table (a step that is not a power of two), and path 12's SiLU MLP at
    (8, 14336): bitwise.  Context beside the kernel: the unfused chain it
    replaces on the card (the lut_activation kernel, then the two PyTorch
    products), timed alike."""
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels.lut_activation import (lut_activation,
                                                    lut_gated_mul,
                                                    lut_gated_mul_plain)
    g = torch.Generator(device="cuda").manual_seed(5)
    # (table, lo, hi, indexing, rows, columns, dtype)
    cases = [(fn, lo, hi, indexing, m, 16384, dt)
             for fn, lo, hi in (("gelu_gate", -8.0, 8.0),
                                ("silu_gate", -10.0, 10.0))
             for indexing in ("trunc", "nearest", "interp")
             for m in (8, 128) for dt in (torch.bfloat16, torch.float32)]
    # path 12: llama-3.2-vision's SiLU MLP at a decode step (d_ff 14336)
    cases.append(("silu_gate", -10.0, 10.0, "interp", 8, 14336,
                  torch.bfloat16))
    for fn, lo, hi, indexing, m, cols, dt in cases:
        spec = TableSpec(fn, 1024, lo, hi, None, indexing)
        x = (torch.randn((m, cols), generator=g, device="cuda") * 4).to(dt)
        up = (torch.randn((m, cols), generator=g, device="cuda") * 2).to(dt)
        got = lut_gated_mul(x, up, spec)
        want = lut_gated_mul_plain(x, up, spec)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # the same single-rounded operations in the same order
        tol = 0.0
        if not (torch.equal(got, want) and torch.isfinite(got).all().item()):
            raise AssertionError(f"lut_gated_mul {fn} {indexing} {m}x{cols} "
                                 f"{dt}: max_abs_err {err}, not bitwise")
        ms = timer(lambda: lut_gated_mul(x, up, spec))
        plain_ms = timer(lambda: lut_gated_mul_plain(x, up, spec), reps=5)
        unfused_ms = timer(lambda: (x * lut_activation(x, spec)).to(dt) * up)
        nbytes = 3 * x.numel() * x.element_size() + 4 * spec.n
        # a gather or two and ~12 f32 operations per element
        bnd, by = bound_ms(nbytes, 12.0 * x.numel(), F32_FLOP_PER_S)
        rows.append(dict(
            kernel="lut_gated_mul",
            case=f"{fn} {indexing} {m}x{cols} {str(dt)[6:]}",
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
#: (8 x 1500 rows, K 512 and 2048), llama-3.2-vision's image (8 x 1601
#: rows of 4096, path 12)
QUANT_CASES = [(8, 2048), (8, 16384), (128, 2048), (128, 16384),
               (12000, 512), (12000, 2048), (VLM_IMG_ROWS, 4096)]


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


#: the backward kernels' cases at gemma-2b's training shapes (path 13 (d):
#: batch 8 x 256 = 2048 tokens): the table pass over the MLP's (2048,
#: 16384) gate, quantize_rows over the projections' inputs (K 2048 and
#: 16384), qmatmul's scales over every projection (M 2048; the gate with
#: the gated GELU table in its epilogue, as under --quant int8 --lut)
TRAIN_TOKENS = 8 * 256
#: qmatmul_bwd's gate: each of dsa, dsb, dbias within this share of the
#: plain version's largest magnitude (f32 sums of up to 16384 terms in
#: another order; measured ~2-4e-7 on the card), and bitwise across two
#: launches
QMM_BWD_TOL = 1e-5


def check_train_bwd(torch, timer, rows):
    """The backward kernels of training under --lut and --quant int8
    against their plain backward (``kernels/ref.py``) on the card at
    gemma-2b's training shapes: lut_gated_mul_bwd (dg, dup) and
    lut_activation_bwd (dx) bitwise, bf16 and f32, every indexing, with
    points at the table's ends planted; quantize_rows_bwd bitwise, bf16
    and f32, with tied, all-zero and floor rows planted; qmatmul_bwd (dsa,
    dsb, dbias) within QMM_BWD_TOL of the plain version's largest
    magnitude and bitwise across two launches, with and without a bias
    and the gated table.  Yardsticks: none for the tables (no PyTorch call
    is a table lookup's slope); autograd's backward of ``torch.amax(
    x.abs(), 1)`` for quantize_rows (the same gradient without the floor);
    ``torch._int_mm`` plus the three reductions for qmatmul (no epilogue
    derivative)."""
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.core.tables import TableSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.lut_activation import (lut_activation_bwd,
                                                    lut_gated_mul_bwd)
    from repro_torch.kernels.qmatmul import qmatmul_bwd
    from repro_torch.kernels.quantize_rows import quantize_rows_bwd
    g = torch.Generator(device="cuda").manual_seed(9)
    m = TRAIN_TOKENS
    for indexing in ("interp", "nearest", "trunc"):
        for dt in (torch.bfloat16, torch.float32):
            spec = TableSpec("gelu_gate", 1024, -8.0, 8.0, None, indexing)
            shape = (m, 16384)
            x = (torch.randn(shape, generator=g, device="cuda") * 4).to(dt)
            x.view(-1)[:6] = torch.tensor([-8.0, 8.0 - 1 / 64, 8.0, -9.0, 9.0,
                                           -8.0 + 1 / 64], device="cuda")
            up = torch.randn(shape, generator=g, device="cuda").to(dt)
            dy = torch.randn(shape, generator=g, device="cuda").to(dt)
            for name in ("lut_gated_mul_bwd", "lut_activation_bwd"):
                if name == "lut_gated_mul_bwd":
                    def run():
                        return lut_gated_mul_bwd(x, up, dy, spec)

                    def plain():
                        return ref.lut_gated_mul_bwd_plain(x, up, dy, spec)
                    tensors = 5       # g, up, dh in; dg, dup out
                else:
                    def run():
                        return (lut_activation_bwd(x, dy, spec),)

                    def plain():
                        return (ref.lut_activation_bwd_plain(x, dy, spec),)
                    # x, dy in, dx out; a step function's gradient is 0,
                    # which needs no input
                    tensors = 3 if indexing == "interp" else 1
                got, want = run(), plain()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    err = max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(got, want))
                    raise AssertionError(f"{name} {indexing} {dt}: not "
                                         f"bitwise (max_abs_err {err})")
                ms = timer(run)
                plain_ms = timer(plain, reps=5)
                nbytes = tensors * x.numel() * x.element_size() + 4 * spec.n
                bnd, by = bound_ms(nbytes, 16.0 * x.numel(), F32_FLOP_PER_S)
                rows.append(dict(
                    kernel=name, case=f"gelu_gate {indexing} {m}x16384 "
                    f"{str(dt)[6:]}", max_abs_err=0.0, tol=0.0, ms=ms,
                    plain_ms=plain_ms, library_ms=None, bound_ms=bnd,
                    bound_by=by))
                log(f"[check] {name} {rows[-1]['case']}: bitwise (lo, the "
                    f"last entry, hi and outside planted) kernel={ms:.4f}ms "
                    f"plain={plain_ms:.4f}ms library=none "
                    f"kernel/library={over_library(rows[-1])} "
                    f"bound={bnd:.5f}ms ({by})")
            del x, up, dy
    qt = FixedPointType(8, 4)
    for k in (2048, 16384):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=g, device="cuda") * 3
            x[0] = 0.0
            x[1] = 0.0
            x[1, 7] = 1e-12
            x[2, [5, 9]] = -(x[2].abs().max() + 1)
            x[2, 11] = -x[2, 5]
            x = x.to(dt)
            ds = torch.randn((m, 1), generator=g, device="cuda")
            got = quantize_rows_bwd(x, ds, qt)
            want = ref.quantize_rows_bwd_plain(x, ds, qt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"quantize_rows_bwd {m}x{k} {dt}: "
                                     f"not bitwise")
            ms = timer(lambda: quantize_rows_bwd(x, ds, qt))
            plain_ms = timer(lambda: ref.quantize_rows_bwd_plain(x, ds, qt),
                             reps=5)
            xa = x.detach().requires_grad_(True)
            amax = xa.abs().amax(dim=1, keepdim=True)
            lib_ms = timer(lambda: torch.autograd.grad(amax, xa, ds,
                                                       retain_graph=True))
            nbytes = 2 * m * k * x.element_size() + 4 * m
            bnd, by = bound_ms(nbytes, 4.0 * m * k, F32_FLOP_PER_S)
            rows.append(dict(kernel="quantize_rows_bwd",
                             case=f"{m}x{k} {str(dt)[6:]}", max_abs_err=0.0,
                             tol=0.0, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bnd, bound_by=by))
            log(f"[check] quantize_rows_bwd {rows[-1]['case']}: bitwise "
                f"(tied, zero and floor rows) kernel={ms:.4f}ms "
                f"plain={plain_ms:.4f}ms library={lib_ms:.4f}ms (amax's "
                f"backward) kernel/library={over_library(rows[-1])} "
                f"bound={bnd:.5f}ms ({by})")
            del x, xa, amax
    gelu = TableSpec("gelu_gate", 1024, -8.0, 8.0, None, "interp")
    cases = [(name, kk, nn, None, False) for name, kk, nn in GEMMA_PROJ]
    cases += [("up/gate +gelu epilogue", 2048, 16384, gelu, True),
              ("wq +bias", 2048, 2048, None, False)]
    for name, kk, nn, spec, gated in cases:
        a = torch.randint(-127, 128, (m, kk), generator=g, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (kk, nn), generator=g, device="cuda",
                          dtype=torch.int8)
        # scales that put the pre-activations over the table's domain
        sa = torch.rand((m, 1), generator=g, device="cuda") * 0.02 / kk ** 0.5
        sb = torch.rand((1, nn), generator=g, device="cuda") * 0.02
        bias = (torch.randn(nn, generator=g, device="cuda")
                if "bias" in name else None)
        dout = torch.randn((m, nn), generator=g, device="cuda").to(
            torch.bfloat16)
        kw = dict(act_spec=spec, act_gated=gated)
        got = qmatmul_bwd(a, b, sa, sb, bias, dout, **kw)
        again = qmatmul_bwd(a, b, sa, sb, bias, dout, **kw)
        want = ref.qmatmul_bwd_plain(a, b, sa, sb, bias, dout, **kw)
        torch.cuda.synchronize()
        det = all(torch.equal(u, v) for u, v in zip(got, again)
                  if u is not None)
        rel = max(((u - v).abs().max() / v.abs().max().clamp_min(1e-30))
                  .item() for u, v in zip(got, want) if u is not None)
        if not (det and rel <= QMM_BWD_TOL):
            raise AssertionError(f"qmatmul_bwd {name}: deterministic {det}, "
                                 f"relative error {rel} (<= {QMM_BWD_TOL})")
        ms = timer(lambda: qmatmul_bwd(a, b, sa, sb, bias, dout, **kw))
        plain_ms = timer(lambda: ref.qmatmul_bwd_plain(a, b, sa, sb, bias,
                                                       dout, **kw), reps=5)

        def library():
            acc = torch._int_mm(a, b).float()
            d = dout.float()
            return ((d * sb) * acc).sum(1), (d * (acc * sa)).sum(0), \
                d.sum(0)
        lib_ms = timer(library)
        nbytes = (m * kk + kk * nn + m * nn * dout.element_size()
                  + 4 * (m + 3 * nn))
        bnd, by = bound_ms(nbytes, 2.0 * m * nn * kk, INT8_OPS_PER_S)
        rows.append(dict(kernel="qmatmul_bwd", case=f"{name} M={m} K={kk} "
                         f"N={nn} dout bfloat16", max_abs_err=rel,
                         tol=QMM_BWD_TOL, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bnd, bound_by=by))
        log(f"[check] qmatmul_bwd {rows[-1]['case']}: relative error "
            f"{rel:.3g} (<= {QMM_BWD_TOL}), bitwise across launches "
            f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms library={lib_ms:.4f}ms"
            f" (_int_mm + reductions) kernel/library="
            f"{over_library(rows[-1])} bound={bnd:.5f}ms ({by})")
        del a, b, dout


#: paged attention's head layouts (Hq, Hkv, D): gemma-2b's, then path
#: 10's at D 128 with query groups of 8 (yi, command-r), 16 (glm4) and 1
#: (olmoe, MHA)
GEMMA_HEADS = (8, 1, 256)
#: zamba2-1.2b's shared block: 32 heads on 32 KV heads (group 1), D 64
ZAMBA2_HEADS = (32, 32, 64)
FAMILY_HEADS = [("yi/command-r", (32, 4, 128)), ("glm4", (32, 2, 128)),
                ("olmoe", (16, 16, 128))]


def _attention_case(torch, g, b, s, tokens, dead_lane, width_tokens,
                    q_dtype, heads=GEMMA_HEADS):
    """Engine-shaped paged attention inputs: ``heads`` (Hq, Hkv, D), 16-row
    pages, distinct pages per lane, the trash page last, qpos so that each
    lane's last query sees ``tokens`` positions."""
    hq, hkv, d = heads
    ps = 16
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


def attention_cases():
    """Phase 3's paged cases: (label, B, S, tokens, dead lane, table
    tokens, (Hq, Hkv, D)), from the model constants alone (the plan's CPU
    test reads them too)."""
    # engine geometry: max_len 161 (prompt 128 + gen 32 + 1), prefill
    # chunk 16 of margin -> a 12-page table; the long case ~4096 tokens
    cases = [("decode", 8, 1, 150, True, 177, GEMMA_HEADS),
             ("prefill", 8, 16, 128, False, 177, GEMMA_HEADS),
             ("verify", 8, SPEC_K + 1, 150, True, 177, GEMMA_HEADS),
             ("decode-4096", 8, 1, 4096, False, 4096 + 16, GEMMA_HEADS)]
    # path 10's geometry: max_len 145 (prompt 128 + gen 16 + 1), chunk 16
    # of margin -> a 11-page table
    for name, heads in FAMILY_HEADS:
        cases += [(f"{name} decode", 8, 1, 134, True, 161, heads),
                  (f"{name} prefill", 8, 16, 128, False, 161, heads)]
    # path 11's geometry: max_len 97 (prompt 64 + gen 32 + 1), no prefill
    # margin (the looped prefill), spec_k + 2 rows under speculation ->
    # a 7-page table
    cases += [("zamba2 decode", 8, 1, 90, True, 103, ZAMBA2_HEADS),
              ("zamba2 verify", 8, SPEC_K + 1, 90, True, 103, ZAMBA2_HEADS)]
    return cases


def paged_plan_name(plan) -> str:
    """A paged launch's plan in a few words."""
    if plan.instance == "control":
        return (f"control ({plan.row_tiles} 8-row tiles x {plan.split} "
                f"partitions, {plan.blocks} blocks)")
    return (f"hopper ({plan.rows_per_block}-row blocks x "
            f"{plan.row_tiles} row tiles; {plan.cpp} blocks of {plan.per} "
            f"entries a partition x {plan.split}; {plan.groups} groups of "
            f"{plan.rw} warps, {plan.stages} stages; {plan.blocks} blocks)")


def check_attention(torch, timer, rows):
    """Paged attention at every case: the Hopper kernel on its plan and
    the control (the first port's kernel) on the same inputs, each held
    to the gate against the plain version; bf16 rows also time both
    kernels, the plain version, SDPA and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_resolve_knobs,
                                                     paged_attention_split,
                                                     paged_attention_unsplit,
                                                     paged_call_plan)
    from repro_torch.kernels.ref import (paged_attention_ref,
                                         paged_attention_split_ref)
    from repro_torch.launch import autotune
    # the knobs ``autotune="fitted"`` resolves (the port's H100 artifact,
    # else the analytic weights) are held against the plain version too
    fitted = autotune.load_estimator("fitted")
    g = torch.Generator(device="cuda").manual_seed(2)
    cases = attention_cases()
    for label, b, s, tokens, dead, width_tokens, heads in cases:
        hq, hkv, d = heads
        for q_dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, bt, qpos = _attention_case(torch, g, b, s, tokens, dead,
                                                  width_tokens, q_dtype, heads)
            np_ = bt.shape[1]
            auto = _resolve_knobs(np_, 16, hkv, b, None, None)
            fk = autotune.resolve(autotune.WorkloadShape(
                pages=np_, page_size=16, hkv=hkv, batch=b), fitted)
            fk = _resolve_knobs(np_, 16, hkv, b, fk.kv_split,
                                fk.pages_per_step)
            for t, split in dict.fromkeys(((1, 1), auto, fk)):
                plan = paged_call_plan(q, kp, vp, bt, kv_split=split,
                                       pages_per_step=t)
                ctl = paged_call_plan(q, kp, vp, bt, kv_split=split,
                                      pages_per_step=t, instance="control")
                if (t, split) == (1, 1):
                    name = "paged_attention_unsplit"

                    def launch(p):
                        return paged_attention_unsplit(q, kp, vp, bt, qpos,
                                                       plan=p)

                    def plain():
                        return paged_attention_ref(q, kp, vp, bt, qpos)
                else:
                    name = "paged_attention_split"

                    def launch(p):
                        return paged_attention_split(
                            q, kp, vp, bt, qpos, kv_split=split,
                            pages_per_step=t, plan=p)

                    def plain():
                        return paged_attention_split_ref(
                            q, kp, vp, bt, qpos, kv_split=split,
                            pages_per_step=t)
                want = plain()
                if q_dtype == torch.bfloat16:
                    # one bf16 ulp at |x| in [2, 4) + relative slack:
                    # both round the same f32 value, summed in another order
                    atol, rtol = 2.0 ** -6, 2.0 ** -8
                else:
                    atol = rtol = 2e-5     # the reference kernel suite's
                errs = {}
                for p in (plan, ctl):
                    got = launch(p)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ok = torch.allclose(got.float(), want.float(), atol=atol,
                                        rtol=rtol)
                    if not (ok and torch.isfinite(got).all().item()):
                        raise AssertionError(
                            f"{name} ({p.instance}) {label} {q_dtype}: "
                            f"max_abs_err {err}")
                    errs[p.instance] = err
                err = errs[plan.instance]
                by = "+".join(k for k, v in (("auto", auto), ("fitted", fk))
                              if v == (t, split))
                row = dict(kernel=name, case=f"{label} B={b} S={s} "
                           f"tokens~{tokens} table={np_} heads={hq}/{hkv} "
                           f"D={d} knobs=(t={t},"
                           f"split={split}{' ' + by if by else ''}) "
                           f"q={str(q_dtype)[6:]}",
                           max_abs_err=err, tol=[atol, rtol],
                           instance=plan.instance,
                           plan=paged_plan_name(plan),
                           control_max_abs_err=errs["control"])
                if q_dtype == torch.bfloat16:
                    row["ms"] = timer(lambda: launch(plan))
                    row["control_ms"] = timer(lambda: launch(ctl))
                    row["plain_ms"] = timer(plain, reps=5)
                    row["library_ms"] = _sdpa_ms(torch, F, timer, q, kp, vp,
                                                 bt, qpos)
                    vis = (torch.clamp(qpos + s, max=np_ * 16)
                           .sum().item())    # visible kv rows of a head
                    nbytes = (q.numel() * 2 * 2 + 2 * vis * hkv * d * 4
                              + bt.numel() * 4 + b * 4)
                    ops = 4.0 * hq * s * vis * d
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        nbytes, ops, F32_FLOP_PER_S)
                rows.append(row)
                log(f"[check] {name} {row['case']}: max_abs_err={err:.3g} "
                    f"(control {errs['control']:.3g}; atol {atol:.3g}, rtol "
                    f"{rtol:.3g}) {row['plan']}"
                    + (f" kernel={row['ms']:.4f}ms "
                       f"control={row['control_ms']:.4f}ms "
                       f"plain={row['plain_ms']:.4f}ms "
                       f"library={fmt_ms(row['library_ms'])} "
                       f"kernel/library={over_library(row)} "
                       f"kernel/control={row['ms'] / row['control_ms']:.2f}x "
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
    # path 13 (a)'s forward: gemma-2b's training shape, B 8, S 256
    ("b gemma-train fwd", 8, 8, 1, 256, 256, 256, True, ("bf16",), None),
    ("c ragged Sq<Skv causal", 2, 8, 2, 77, 200, 64, True, ("bf16",), None),
    ("c ragged Sq>Skv", 2, 8, 2, 200, 77, 64, False, ("bf16",), None),
    ("c MLA-width", 1, 16, 16, 256, 256, 192, True, ("bf16",), 128),
    # a head dim TMA cannot address (not a multiple of 8): the mma.sync
    # kernel, the one case that must not take the TMA kernel
    ("c D60 mma route", 2, 8, 2, 200, 200, 60, True, ("bf16",), None),
    # path 10's cache-free forwards at S 512: glm4's group of 16 at D 128,
    # deepseek's MLA naive form (128 heads, D 192, V padded from 128)
    ("e glm4 D128 group16", 1, 32, 2, 512, 512, 128, True, ("bf16",), None),
    ("e deepseek MLA", 1, 128, 128, 512, 512, 192, True, ("bf16",), 128),
    # path 11's zamba2 cache-free forward: batch 8, S 512, MHA at D 64
    ("f zamba2 forward", 8, 32, 32, 512, 512, 64, True, ("bf16",), None),
    # path 12's llama-3.2-vision cache-free forward: batch 4, S 512, 32
    # heads on 8 KV heads of 128 (the self layers, causal)
    ("g vlm forward", 4, 32, 8, 512, 512, 128, True, ("bf16",), None),
]


def bf16_ulps(torch, a, b) -> int:
    """The largest distance in bf16 ulps between two bf16 tensors (0 for
    bitwise equal ones; +0 and -0 count as equal)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i >= 0, i, -(i & 0x7FFF))
    return int((ordered(a) - ordered(b)).abs().max().item())


def flash_grids(b, hq, hkv, sq, skv, d, causal):
    """Every grid the TMA kernel takes for a shape (FlashFwdPlan): one
    consumer a block, two on 128 rows, two on a GQA head pair (even
    groups), three on 192 rows (D <= 64)."""
    from repro_torch.kernels.flash_attention import FlashFwdPlan
    grids = {"one": (1, False), "two-rows": (2, False)}
    if (hq // hkv) % 2 == 0:
        grids["two-heads"] = (2, True)
    if d <= 64:
        grids["three"] = (3, False)
    return {name: FlashFwdPlan(b, hq, hkv, sq, skv, d, causal, wgs, pack)
            for name, (wgs, pack) in grids.items()}


def grid_name(plan) -> str:
    return {1: "one", 3: "three"}.get(plan.wgs, "two-heads" if
                                      plan.pack_heads else "two-rows")


def check_flash(torch, timer, rows):
    """The flash kernel against its plain version (same inputs, on the
    card), with SDPA's time as the library yardstick (never called by
    the port).  bf16 (the tensor-core kernels, whose three bf16 terms of
    p carry the plain version's f32 p): one bf16 ulp of the output plus
    2e-5 (the f32 sums run in another order); f32 (the CUDA-core kernel):
    atol = rtol = 2e-5.  Every bf16 case must take the route that
    ``flash_fwd_route`` gives it: the TMA kernel for a head dim that is a
    multiple of 8 (every path's shape), the mma.sync kernel otherwise.
    For the TMA kernel each case also logs its grid (``flash_fwd_plan``),
    whether its output is bitwise the mma.sync kernel's on the same
    inputs (or the largest difference in bf16 ulps), and the time of
    every grid the kernel takes for the shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import (
        FLASH_FWD_ROUTES, _flash_fwd_launch, flash_attention,
        flash_attention_plain, flash_fwd_plan)
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
            route = ("f32" if dt == torch.float32 else
                     "wgmma" if d % 8 == 0 else "mma")
            before = dict(FLASH_FWD_ROUTES)
            got = flash_attention(q, k, v, causal=causal)
            ran = [r for r in FLASH_FWD_ROUTES
                   if FLASH_FWD_ROUTES[r] != before[r]]
            if ran != [route]:
                raise AssertionError(f"flash_attention {label} {dname}: ran "
                                     f"{ran}, not the {route} kernel")
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
            row = dict(kernel="flash_attention",
                       case=f"{label} B={b} H={hq}/{hkv} Sq={sq} "
                       f"Skv={skv} D={d} causal={causal} {dname}",
                       route=route, max_abs_err=err, tol=tol, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                       bound_by=by)
            extra = ""
            if route == "wgmma":
                plan = flash_fwd_plan(b, hq, hkv, sq, skv, d, causal=causal,
                                      sms=_cuda.sm_count(q.device))
                old, _ = _flash_fwd_launch(q, k, v, causal, None, False,
                                           None)
                ulps = bf16_ulps(torch, got, old)
                grid_ms = {name: timer(lambda: _flash_fwd_launch(
                    q, k, v, causal, None, False, alt))
                    for name, alt in flash_grids(b, hq, hkv, sq, skv, d,
                                                 causal).items()}
                grid_ms["mma.sync kernel"] = timer(lambda: _flash_fwd_launch(
                    q, k, v, causal, None, False, None))
                row.update(grid=grid_name(plan), blocks=plan.blocks,
                           bitwise_old=ulps == 0, old_max_ulps=ulps,
                           grid_ms=grid_ms)
                extra = (f" grid={row['grid']} blocks={plan.blocks} "
                         f"bitwise old kernel: "
                         + ("yes" if ulps == 0 else f"max {ulps} ulp")
                         + " grids(ms): " + " ".join(
                             f"{k_}={v_:.4f}" for k_, v_ in grid_ms.items()))
            rows.append(row)
            log(f"[check] flash_attention {rows[-1]['case']}: "
                f"route={route} max_abs_err={err:.3g} ({tol}) "
                f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                f"library(SDPA)={fmt_ms(lib_ms)} "
                f"kernel/library={over_library(rows[-1])} "
                f"bound={bnd:.4f}ms ({by})" + extra)


#: the flash backward's cases, as FLASH_CASES: (h) gemma-2b's training
#: step (path 13 (a)) and its microbatch under path 14 (B 4), the whisper
#: encoder, glm4's group of 16, deepseek's
#: MLA naive form (V zero-padded from 128), a ragged causal shape
FLASH_BWD_CASES = [
    ("h gemma-train", 8, 8, 1, 256, 256, 256, True, ("bf16", "f32"), None),
    ("h gemma-train B4", 4, 8, 1, 256, 256, 256, True, ("bf16", "f32"), None),
    ("h whisper-encoder", 8, 8, 8, 1500, 1500, 64, False, ("bf16",), None),
    ("h glm4 D128 group16", 1, 32, 2, 512, 512, 128, True, ("bf16",), None),
    ("h deepseek MLA", 1, 128, 128, 512, 512, 192, True, ("bf16",), 128),
    ("h ragged causal", 2, 8, 2, 100, 333, 64, True, ("bf16", "f32"), None),
]
#: the backward's gates: relative L2 of dq, dk, dv against the plain
#: version (the same formulas in f32, sums in another order).  bf16: both
#: sides round their f32 sums to bf16 once, so most elements agree and a
#: few differ by one bf16 ulp; the gate lies between the sound readings
#: and a control that rounds p and ds to bf16 before their products (the
#: tensor-core shortcut that f32 softmax and accumulation rule out), which
#: each bf16 case computes and must see fail (PERF.md section 6)
FLASH_BWD_TOL = {"f32": 1e-5, "bf16": 1e-4}


def _bwd_bf16_shortcut(torch, q, k, v, o, lse, do, causal):
    """The bf16 gate's control: ``flash_attention_bwd_plain`` with p and
    ds rounded to bf16 before the products that take them."""
    from repro_torch.kernels.ref import _flash_pairs
    b, hq, sq, _ = q.shape
    hkv = k.shape[1]
    qs, s, mask, scale = _flash_pairs(q, k, causal, None)
    lse_g = lse.reshape(b, hkv, hq // hkv, sq, 1)
    p = torch.where(mask, torch.exp(s - torch.where(
        torch.isfinite(lse_g), lse_g, 0.0)), 0.0)
    dof = do.reshape(b, hkv, hq // hkv, sq, -1).float()
    of = o.reshape(b, hkv, hq // hkv, sq, -1).float()
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    ds = p * (dp - torch.sum(dof * of, dim=-1, keepdim=True))
    del s, dp
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qs)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def same_raw_bits(torch, a, b) -> bool:
    """Tensors of one dtype equal bit for bit (any float width)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(ints[a.dtype]), b.contiguous().view(ints[b.dtype]))


def rel_l2(torch, a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def check_flash_bwd(torch, timer, rows):
    """The flash backward (``flash_attention_bwd``) against its plain
    version on the same q, k, v, o, lse and do, at FLASH_BWD_CASES: dq, dk
    and dv within FLASH_BWD_TOL (in bf16 the control
    ``_bwd_bf16_shortcut`` must fall outside it), bitwise equal across two
    launches (no atomics), the forward's ``lse`` against the plain log-sum-exp (-inf
    rows alike), and the forward's output with ``lse`` bitwise the output
    without it.  SDPA's backward at the same shape is the yardstick
    (context only, never called by the port)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd)
    from repro_torch.kernels.ref import flash_attention_lse_plain
    g = torch.Generator(device="cuda").manual_seed(5)
    for (label, b, hq, hkv, sq, skv, d, causal, dtypes,
         dv) in FLASH_BWD_CASES:
        for dname in dtypes:
            dt = torch.bfloat16 if dname == "bf16" else torch.float32

            def rnd(*shape):
                return torch.randn(shape, generator=g, device="cuda").to(dt)
            q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv,
                                                                   skv, d)
            do = rnd(b, hq, sq, d)
            if dv is not None:        # MLA: V zero-padded, do sliced to dv
                v[..., dv:] = 0
                do[..., dv:] = 0
            o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                         with_lse=True)
            o0, _ = flash_attention_fwd(q, k, v, causal=causal)
            if not same_raw_bits(torch, o, o0):
                raise AssertionError(f"flash_attention {label} {dname}: the "
                                     f"output moved when lse was written")
            lse_p = flash_attention_lse_plain(q, k, causal=causal)
            fin = torch.isfinite(lse_p)
            if not torch.equal(fin, torch.isfinite(lse)):
                raise AssertionError(f"flash lse {label} {dname}: -inf rows "
                                     f"differ from the plain version's")
            lse_err = float((lse - lse_p)[fin].abs().max()) if fin.any() \
                else 0.0
            lse_tol = 1e-4 if dt == torch.bfloat16 else 2e-5
            if lse_err > lse_tol * max(1.0, float(lse_p[fin].abs().max())):
                raise AssertionError(f"flash lse {label} {dname}: max abs "
                                     f"err {lse_err} beyond {lse_tol}")
            got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            want = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal)
            torch.cuda.synchronize()
            if not all(same_raw_bits(torch, x, y)
                       for x, y in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd {label} {dname}: "
                                     f"two launches gave different bits")
            errs = [rel_l2(torch, x, y) for x, y in zip(got, want)]
            tol = FLASH_BWD_TOL[dname]
            if not (max(errs) <= tol and all(
                    torch.isfinite(x).all().item() for x in got)):
                raise AssertionError(f"flash_attention_bwd {label} {dname}: "
                                     f"relative L2 (dq, dk, dv) {errs} beyond "
                                     f"{tol}")
            control = None
            if dt == torch.bfloat16:
                control = [rel_l2(torch, x, y) for x, y in zip(
                    _bwd_bf16_shortcut(torch, q, k, v, o, lse, do, causal),
                    want)]
                if max(control) <= tol:
                    raise AssertionError(
                        f"flash_attention_bwd {label} {dname}: the gate "
                        f"{tol} passes the control that rounds p and ds to "
                        f"bf16 (relative L2 {control})")
            if dv is not None and got[2][..., dv:].abs().max().item() != 0:
                raise AssertionError(f"flash_attention_bwd {label}: gradient "
                                     f"leaked into V's padded columns")
            err = max(float((x.float() - y.float()).abs().max())
                      for x, y in zip(got, want))
            ms = timer(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal=causal))
            plain_ms = timer(lambda: flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=causal), reps=3)
            lib_ms = yardstick(timer, _sdpa_backward(torch, F, q, k, v, do,
                                                     causal))
            if causal:
                qpos = torch.arange(sq) + (skv - sq)
                pairs = int(torch.clamp(qpos + 1, 0, skv).sum())
            else:
                pairs = sq * skv
            # q, o, do read and dq written; k, v read and dk, dv written;
            # lse read; five products of pairs x D per query head
            nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
                + 4 * lse.numel()
            bnd, by = bound_ms(nbytes, 10.0 * b * hq * pairs * d,
                               BF16_FLOP_PER_S if dt == torch.bfloat16
                               else F32_FLOP_PER_S)
            rows.append(dict(kernel="flash_attention_bwd",
                             case=f"{label} B={b} H={hq}/{hkv} Sq={sq} "
                             f"Skv={skv} D={d} causal={causal} {dname}",
                             max_abs_err=err, rel_l2_dq_dk_dv=errs,
                             control_rel_l2_dq_dk_dv=control,
                             tol=f"rel L2 {tol}", lse_max_abs_err=lse_err,
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bnd, bound_by=by))
            log(f"[check] flash_attention_bwd {rows[-1]['case']}: rel L2 "
                f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} "
                f"(<= {tol:.3g}"
                + ("" if control is None else
                   f"; control with p, ds rounded to bf16: "
                   f"{', '.join(f'{c:.3g}' for c in control)}")
                + f"), bitwise across launches, lse err "
                f"{lse_err:.3g}, o with lse == o without: kernel={ms:.4f}ms "
                f"plain={plain_ms:.4f}ms library(SDPA backward)="
                f"{fmt_ms(lib_ms)} kernel/library={over_library(rows[-1])} "
                f"bound={bnd:.4f}ms ({by})")
            del q, k, v, do, o, o0, lse, lse_p, got, again, want


def _sdpa_backward(torch, F, q, k, v, do, causal):
    """The library yardstick for the flash backward: SDPA's backward on
    K/V expanded to the query heads (its forward and the expansion not
    timed)."""
    group = q.shape[1] // k.shape[1]
    qe = q.detach().requires_grad_(True)
    ke = k.repeat_interleave(group, dim=1).requires_grad_(True)
    ve = v.repeat_interleave(group, dim=1).requires_grad_(True)
    sq, skv = q.shape[2], k.shape[2]
    if causal and sq != skv:
        mask = (torch.arange(sq, device="cuda")[:, None] + (skv - sq)
                >= torch.arange(skv, device="cuda")[None, :])
        out = F.scaled_dot_product_attention(qe, ke, ve, attn_mask=mask)
    else:
        out = F.scaled_dot_product_attention(qe, ke, ve, is_causal=causal)
    return lambda: torch.autograd.grad(out, (qe, ke, ve), do,
                                       retain_graph=True)


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
    np_, hkv, ps = bt.shape[1], kp.shape[1], kp.shape[2]
    idx = bt.to(torch.int64)
    k = kp[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, np_ * ps, d)
    v = vp[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, np_ * ps, d)
    k = k.repeat_interleave(hq // hkv, dim=1).contiguous()
    v = v.repeat_interleave(hq // hkv, dim=1).contiguous()
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
             first=(), block=8, walls=None, busy=None, ids=None,
             control=False):
    """Drive one path through the engine's entry points: the launch counts
    are set to 0 just before and read just after; every kernel named in
    ``expect`` must have launched, and a graphed engine must have run its
    blocks as CUDA graphs.  ``sampling``: per-prompt (temperature, top_k)
    (default greedy); blocks of the lengths in ``first``, then of
    ``block`` steps (rounds, under speculation).  ``walls``: a list that
    receives (wall ms, tokens, live lanes, steps, captured) per block.
    ``busy``: a list that receives (device busy ms, device kernels and
    copies) per step (round) of the third block, traced by the profiler
    (which runs it twice: the third and fourth blocks).  ``ids``: the
    request ids of an engine that has admitted (or restored) ``prompts``
    already; only its blocks are driven and counted.  Paged attention
    runs the Hopper kernel: the control's launches must be 0 unless
    ``control`` (a run whose prefill chunks ``paged_plan`` routes to
    it).  Returns (run summary, counts)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.lifecycle import RequestStatus
    sampling = sampling or [(0.0, 0)] * len(prompts)
    reset_launch_counts()
    t1 = time.perf_counter()
    if ids is None:
        ids = [eng.submit(p, gen_len=gen_len, temperature=t, top_k=k)
               for p, (t, k) in zip(prompts, sampling)]
        eng.try_admit()
    blocks = 0
    while eng.live.any() or eng.waiting:
        n = first[blocks] if blocks < len(first) else block
        if busy is not None and blocks == 2:
            ms, nk = _profiled_busy(torch, lambda: eng.step_many(n))
            busy.append((None if ms is None else ms / n, nk / n))
            blocks += 2
            continue
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
    if not control:
        no_control(label, counts)
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


def no_control(label, counts) -> None:
    """Paged attention ran the Hopper kernel alone: ``paged_plan`` routes
    to the control only path 1's unsplit prefill chunks."""
    if counts.get("paged_attention_control", 0):
        raise AssertionError(
            f"{label}: the control paged kernel launched "
            f"{counts['paged_attention_control']} times where the plan "
            f"sends paged attention to the Hopper kernel")


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
        # unsplit, gemma-2b's prefill chunk is one wave of the control's
        # blocks: paged_plan sends it there (its decode stays on Hopper)
        run, counts = run_path(torch, label, eng, reqs, gen_len,
                               expect + ("quantize_rows",),
                               control="kv_split" in knobs)
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

    # -- path 8: the request lifecycle on path 1's configuration -----------
    rows_out["lifecycle"] = serve_lifecycle(torch, cfg, int8, params,
                                            geometry, record=record)

    # -- path 9: the journal, the fleet, class quotas, the autotuner -------
    rows_out["resilience"] = serve_resilience(torch, cfg, int8, params,
                                              geometry, prompts,
                                              record=record)

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


def plain_margins(torch, eng, prompts, streams, tops=None):
    """The plain Engine's own logits along its streams: ``eng`` (fresh,
    the plain run's configuration) prefills ``prompts``, then decode
    steps at the same batch, cache and knobs, every lane teacher-forced
    along its stream.  Returns per lane the top-2 margin of the logits
    that chose each token (token 0 is the prefill's, shared by both
    engines: None); fails if the replay's argmax is not the stream.
    ``tops``: a list that receives per lane the top logit of each token
    (None for token 0)."""
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
    if tops is not None:
        tops.extend([None] for _ in range(b))
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
        if tops is not None:
            for r, v in enumerate(top2[:, 0].tolist()):
                tops[r].append(v)
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


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 values at ``v`` (8 significant bits)."""
    import math
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7) if v else 2.0 ** -133


def parting_log(label, streams, plain, margins, tops):
    """Where each stream first parts from the plain one: per lane
    (position, plain top-2 margin, that margin in bf16 ulps of the top
    logit), None when identical; logged, not gated."""
    out = []
    for r, (a, b) in enumerate(zip(streams, plain)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            out.append(None)
            continue
        m = margins[r][i]
        ulps = None if m is None else m / bf16_ulp(tops[r][i])
        out.append((i, m, ulps))
        log(f"[res] {label}: lane {r} parts at token {i}, plain top-2 "
            f"margin {m} ({ulps} bf16 ulps of the top logit)")
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
              True),
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
    target on the einsum path, the verify pass one query position a call,
    so its rows are plain decode's); (c) (a) with half the lanes at
    temperature 0.8 and top_k 40.  Gates: greedy streams equal the plain
    Engine's on the same prompts and cache (spec_gate, dense and paged
    alike); graphed == eager streams and launch
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


#: path 8: 16 requests, each a shared system prompt of LIFE_SYSTEM tokens
#: (6 pages) and LIFE_OWN of its own, 32 greedy tokens each; the fault
#: schedule of its chaos run (block rounds, 1-based)
LIFE_SYSTEM, LIFE_OWN, LIFE_REQUESTS = 96, 32, 16
LIFE_FAULTS = {2: "raise", 3: "nan", 4: "corrupt", 5: "slow"}


def _timed(torch, eng, name, sink):
    """Wrap ``eng.<name>`` (the Engine calls it through ``self``) so that
    every call appends (ms, args) to ``sink``, the card synchronized before
    and after it."""
    orig = getattr(eng, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        sink.append(((time.perf_counter() - t0) * 1e3, a))
        return out
    setattr(eng, name, wrapper)


def _ttft_by_id(eng):
    """{request id: TTFT seconds}, filled as each lane finishes."""
    out, orig = {}, eng.finish

    def finish(slot, *a, **kw):
        m = eng._req_meta.get(slot)
        if m is not None:
            out[m["id"]] = m["ttft_s"]
        return orig(slot, *a, **kw)
    eng.finish = finish
    return out


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def serve_lifecycle(torch, cfg, ctx, params, geometry, *, record):
    """Path 8: path 1's configuration (int8 weights, bf16, paged f32 KV at
    the auto knobs, page 16, prefill chunk 16, batch 8, graphed) on
    LIFE_REQUESTS requests that share a LIFE_SYSTEM-token system prompt,
    four ways: (v) plain, a full pool, the reference run; (p)
    ``prefix_cache``: the second wave of 8 hits the system prompt's 6
    pages and prefills its 32 own tokens only; (s) ``preempt`` over a pool
    of 70% of what 8 lanes' budgets need, so that admission blocks and
    victims spill; (c) a fault schedule (LIFE_FAULTS) with recovery on
    and a straggler monitor that flags a single slow block.  Gates: every
    request completes with its 32 tokens; qmatmul, quantize_rows (one per
    qmatmul) and split paged attention launch in each run; (p), (s) and
    (c) give (v)'s streams, or part only where (v)'s own top-2 margin is
    below SPEC_MARGIN_BOUND; (p) hits, (s) preempts, (c) replays >= 3
    times, flags the slow block and captures no more graphs than (v).
    Logged: prefill tokens computed and prefill ms per admission, TTFT of
    each wave (hits against misses), the decode blocks' wall per step
    (admission left out), spill and resume ms per page, snapshot and
    restore ms a block."""
    import numpy as np
    from repro_torch.ft import ServingFaultInjector, StragglerMonitor
    from repro_torch.launch.serve import Engine
    rs = np.random.RandomState(0)
    system = rs.randint(0, cfg.vocab, (LIFE_SYSTEM,))
    prompts = [np.concatenate([system, rs.randint(0, cfg.vocab, (LIFE_OWN,))])
               for _ in range(LIFE_REQUESTS)]
    gen_len, batch = 32, geometry["batch"]
    expect = ("qmatmul", "quantize_rows", "paged_attention_split")
    out, streams, engines = {}, {}, {}

    def run(label, **kw):
        eng = Engine(cfg, ctx, params, paged=True, **geometry, **kw)
        t = {k: [] for k in ("prefill", "block", "snapshot", "restore",
                             "preempt", "resume")}
        for name, key in (("_prefill_chunked", "prefill"),
                          ("_block_decode", "block"),
                          ("snapshot", "snapshot"), ("restore", "restore"),
                          ("_preempt", "preempt"), ("_resume", "resume")):
            _timed(torch, eng, name, t[key])
        ttft = _ttft_by_id(eng)
        r, counts = run_path(torch, f"path 8 {label}", eng, prompts, gen_len,
                             expect)
        one_quantizer_per_qmatmul(label, counts)
        st = eng.stats()
        streams[label] = r.pop("streams")
        record(f"path 8 {label}", r, counts)
        waves = [[ttft[i] for i in range(w * batch, (w + 1) * batch)
                  if i in ttft] for w in range(2)]
        row = dict(run=r, prefill_tokens=st["prefill_tokens"],
                   prefill_ms_per_admission=[
                       (len(a[0]), ms) for ms, a in t["prefill"]],
                   ttft_wave1_s=_mean(waves[0]), ttft_wave2_s=_mean(waves[1]),
                   # the decode blocks alone (upload to download), the
                   # first one (eager, then captured) left out
                   decode_ms_per_step=statistics.median(
                       ms / a[0] for ms, a in t["block"][1:]),
                   graph_captures=st["graph_captures"],
                   **{k: st[k] for k in ("preemptions", "spilled_pages",
                                         "replays", "straggler_blocks")})
        if eng.prefix_cache:
            row.update({k: st[k] for k in ("prefix_hits", "prefix_hit_pages",
                                           "prefix_tokens_saved",
                                           "cow_copies")})
        if t["preempt"]:
            row["spill_ms_per_page"] = sum(ms for ms, _ in t["preempt"]) \
                / max(st["spilled_pages"], 1)
        if t["resume"]:
            row["resume_ms_per_page"] = sum(ms for ms, _ in t["resume"]) \
                / max(sum(a[1]["n_pages"] for _, a in t["resume"]), 1)
        if t["snapshot"]:
            row["snapshot_ms"] = _mean([ms for ms, _ in t["snapshot"]])
            row["restore_ms"] = _mean([ms for ms, _ in t["restore"]])
            row["snapshot_mb"] = sum(
                x.numel() * x.element_size() for x in eng.cache["dense"][
                    "pages"].values()) / 1e6
        engines[label] = eng
        out[label] = row
        log(f"[life] {label}: prefill tokens {row['prefill_tokens']}, "
            f"prefill ms per admission (lanes, ms) "
            f"{[(n, round(ms, 3)) for n, ms in row['prefill_ms_per_admission']]}"
            f"; TTFT wave 1 {row['ttft_wave1_s']:.4f} s, wave 2 "
            f"{row['ttft_wave2_s']:.4f} s; decode block wall "
            f"{row['decode_ms_per_step']:.3f} ms a step; " + ", ".join(
                f"{k} {row[k]}" for k in ("prefix_hits", "prefix_tokens_saved",
                                          "cow_copies", "preemptions",
                                          "spilled_pages", "replays",
                                          "straggler_blocks", "graph_captures")
                if k in row)
            + "".join(f", {k} {row[k]:.3f}" for k in (
                "spill_ms_per_page", "resume_ms_per_page", "snapshot_ms",
                "restore_ms", "snapshot_mb") if k in row))
        return eng

    plain = run("v plain")
    need = plain.allocator.pages_for(plain._token_budget(len(prompts[0]),
                                                         gen_len))
    pool = int(0.7 * batch * need)
    run("p prefix cache", prefix_cache=True)
    run("s preempt", preempt=True, num_pages=pool)
    inj = ServingFaultInjector(LIFE_FAULTS)
    run("c chaos", fault_injector=inj,
        straggler=StragglerMonitor(window=8, ratio=3.0, patience=1))
    out["s preempt"]["num_pages"] = pool
    out["s preempt"]["pages_per_request"] = need
    out["c chaos"]["injected"] = inj.events

    margins = []

    def plain_margin_rows():
        if not margins:
            for h in range(0, LIFE_REQUESTS, batch):
                margins.extend(plain_margins(
                    torch, Engine(cfg, ctx, params, paged=True,
                                  graphs=False, **geometry),
                    prompts[h:h + batch], streams["v plain"][h:h + batch]))
        return margins

    for label in ("p prefix cache", "s preempt", "c chaos"):
        same = streams[label] == streams["v plain"]
        out[label]["gate_vs_plain"] = None if same else spec_gate(
            f"path 8 {label}", streams[label], streams["v plain"],
            plain_margin_rows())
        log(f"[life] {label}: streams {'identical to' if same else 'gated against'}"
            f" (v)'s")
    p, s, c = (out[k] for k in ("p prefix cache", "s preempt", "c chaos"))
    if p["prefix_hits"] == 0:
        raise AssertionError("path 8 (p): no prefix-cache hit")
    if s["preemptions"] == 0:
        raise AssertionError(f"path 8 (s): no preemption over {pool} pages")
    if c["replays"] < 3:
        raise AssertionError(f"path 8 (c): {c['replays']} replays, expected "
                             f">= 3 for {LIFE_FAULTS}")
    if c["graph_captures"] != out["v plain"]["graph_captures"]:
        raise AssertionError(f"path 8 (c): {c['graph_captures']} graphs "
                             f"captured against (v)'s "
                             f"{out['v plain']['graph_captures']}: recovery "
                             f"recaptured")
    flagged = [r for r, _ in engines["c chaos"].straggler.events]
    if 5 not in flagged:
        raise AssertionError(f"path 8 (c): the slow block (round 5) was not "
                             f"flagged ({flagged})")
    c["straggler_rounds"] = flagged
    log(f"[life] (p) against (v): prefill tokens {out['v plain']['prefill_tokens']}"
        f" -> {p['prefill_tokens']}, wave-2 TTFT "
        f"{out['v plain']['ttft_wave2_s']:.4f} -> {p['ttft_wave2_s']:.4f} s, "
        f"decode block wall per step {out['v plain']['decode_ms_per_step']:.3f}"
        f" -> {p['decode_ms_per_step']:.3f} ms; (c) straggler rounds "
        f"{flagged}")
    del engines
    return out


#: path 9: the mixed priority classes of its 16 requests, the crash rounds
#: of its journal runs (after the first durable snapshot, before any) and
#: the fleet's fault rounds
RES_PRIOS = ("realtime", "standard", "batch", "standard") * 4
RES_CRASHES = (("after a snapshot", 6), ("journal only", 2))
RES_KILL_ROUND = 2


def _res_drive(torch, eng, prompts, gen_len, prios, block=8):
    """Submit with classes, drain, retire.  Returns the ids."""
    ids = [eng.submit(p, gen_len=gen_len, priority=c)
           for p, c in zip(prompts, prios)]
    eng.try_admit()
    while eng.live.any() or eng.waiting:
        eng.step_many(block)
    eng.retire_finished()
    torch.cuda.synchronize()
    return ids


def _res_complete(label, results, ids, gen_len):
    from repro_torch.launch.lifecycle import RequestStatus
    for i in ids:
        r = results.get(i)
        if r is None or r["status"] is not RequestStatus.COMPLETED \
                or len(r["tokens"]) != gen_len:
            raise AssertionError(f"path 9 {label}: request {i} did not "
                                 f"complete: {r and r['status']}")


def serve_resilience(torch, cfg, ctx, params, geometry, prompts, *, record):
    """Path 9: path 1's configuration (gemma-2b, int8 weights, bf16, paged
    f32 KV at the auto knobs, batch 8, prompt 128, gen 32, 16 requests of
    mixed priority classes, graphed) through the durable journal, the
    fleet, class quotas and the autotuner.  Every run resets the launch
    counts and fails unless qmatmul, quantize_rows (one per qmatmul) and
    split paged attention launched.

    (j) a durable run (``snapshot_every`` 2), then a crash at a round
    after the first durable snapshot and one before any, each recovered
    into a fresh Engine (same arguments, no ``durable_dir``): streams and
    ``done`` order equal the durable run's, all COMPLETED.  (f) two
    replicas and a journal-tailing hot standby: fault-free (every id once,
    no death), the primary killed (one promotion, streams equal), the
    secondary killed (its requests re-dispatched once, gated as path 6's
    against the fault-free streams).  (q) a BATCH flood against a
    REALTIME floor on path 8 (s)'s pool: the realtime requests admitted
    while the flood runs, no class over its cap.  (a) ``analytic`` gives
    ``off``'s knobs (8, 2) and streams, ``decode_block`` 32; ``fitted``
    (the port's H100 artifact, or a short sweep here) logged with its
    knobs here and at ~4096 tokens, its streams bitwise an ``off``
    Engine's at the same knobs; with f32 weights and compute its streams
    gated against analytic's as path 6's, with int8 weights (f32 or bf16
    compute) where they part logged (another split sums attention in
    another order, and the activation quantizer or a bf16 rounding can
    turn that into another token); the n-gram spec run
    with ``analytic`` (adaptive ``spec_k``) equals the fixed-k one.
    Logged: fsync'd append and durable snapshot ms, recovery ms, promotion
    time, journal lag, device busy of a fleet round against one Engine's,
    memory on the card after each rebuild."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.ft import (FleetFaultInjector, InjectedCrash,
                                ServingFaultInjector)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import autotune, calibrate
    from repro_torch.launch.fleet import Fleet
    from repro_torch.launch.serve import Engine
    from repro_torch.models import lm
    from repro_torch.nn.context import QuantContext
    gen_len, batch = 32, geometry["batch"]
    expect = ("qmatmul", "quantize_rows", "paged_attention_split")
    out = {"memory_gib": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_path9_")

    def mem(tag):
        # what is still referenced: dead objects in cycles collected first
        gc.collect()
        torch.cuda.synchronize()
        out["memory_gib"][tag] = torch.cuda.memory_allocated() / 2**30
        log(f"[res] memory on the card {tag}: "
            f"{out['memory_gib'][tag]:.3f} GiB allocated")

    def counted(label, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        missing = [k for k in expect if counts[k] == 0]
        if missing:
            raise AssertionError(f"path 9 {label}: kernels of the path "
                                 f"never launched: {missing} ({counts})")
        one_quantizer_per_qmatmul(f"path 9 {label}", counts)
        no_control(f"path 9 {label}", counts)
        record(f"path 9 {label}", dict(launches=counts,
                                       wall_s=time.perf_counter() - t0),
               counts)
        return res

    def engine(**kw):
        return Engine(cfg, ctx, params, paged=True, **geometry, **kw)

    def streams_of(eng, ids):
        return [eng.results[i]["tokens"] for i in ids]

    mem("before path 9")
    try:
        # -- (j) the durable journal and warm restart ---------------------
        appends, saves = [], []
        j0 = engine(durable_dir=os.path.join(tmp, "j0"), snapshot_every=2)
        _timed(torch, j0._journal, "append", appends)
        _timed(torch, j0, "_save_durable", saves)
        ids = counted("j durable", lambda: _res_drive(
            torch, j0, prompts, gen_len, RES_PRIOS))
        _res_complete("j durable", j0.results, ids, gen_len)
        if j0._round <= max(r for _, r in RES_CRASHES):
            raise AssertionError(f"path 9 (j): {j0._round} rounds, too few "
                                 f"for the crash rounds {RES_CRASHES}")
        want, want_done = streams_of(j0, ids), list(j0.done)
        snap_mb = os.path.getsize(os.path.join(
            tmp, "j0", "step_00000000", "blob.npy")) / 1e6
        blocks = [ms for ms, a in appends if a[0][0] == "block"]
        out["j"] = dict(rounds=j0._round, journal_records=j0._journal.count,
                        append_ms_per_block=_mean(blocks),
                        append_ms_all=_mean([ms for ms, _ in appends]),
                        snapshots=len(saves),
                        snapshot_ms=_mean([ms for ms, _ in saves]),
                        snapshot_mb=snap_mb,
                        graph_captures=j0.stats()["graph_captures"])
        log(f"[res] (j) durable run: {j0._round} rounds, "
            f"{j0._journal.count} journal records, fsync'd append "
            f"{out['j']['append_ms_per_block']:.3f} ms per block record "
            f"({out['j']['append_ms_all']:.3f} ms mean over all), "
            f"{len(saves)} durable snapshots of {snap_mb:.1f} MB at "
            f"{out['j']['snapshot_ms']:.1f} ms each")
        del j0
        for tag, rnd in RES_CRASHES:
            d = os.path.join(tmp, f"crash{rnd}")
            dead = engine(durable_dir=d, snapshot_every=2,
                          fault_injector=ServingFaultInjector({rnd: "crash"}))

            def crash_and_recover():
                try:
                    _res_drive(torch, dead, prompts, gen_len, RES_PRIOS)
                except InjectedCrash:
                    pass
                else:
                    raise AssertionError(f"path 9 (j) {tag}: no crash")
                mem(f"after the crash at round {rnd}")
                rec = engine()
                restores, replays = [], []
                _timed(torch, rec, "restore", restores)
                _timed(torch, rec, "_replay_event", replays)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                info = rec.recover(d)
                torch.cuda.synchronize()
                rec_ms = (time.perf_counter() - t0) * 1e3
                while rec.live.any() or rec.waiting:
                    rec.step_many(8)
                rec.retire_finished()
                return rec, info, rec_ms, restores, replays

            rec, info, rec_ms, restores, replays = counted(
                f"j crash {tag}", crash_and_recover)
            mem(f"after recovering from round {rnd}")
            got = streams_of(rec, ids)
            if got != want or rec.done != want_done:
                first = [next((i for i, (x, y) in enumerate(zip(a, b))
                               if x != y), None) for a, b in zip(got, want)]
                raise AssertionError(f"path 9 (j) crash {tag} at round {rnd}:"
                                     f" recovered streams differ from the "
                                     f"durable run's (first diffs {first})")
            _res_complete(f"j crash {tag}", rec.results, ids, gen_len)
            restore_ms = sum(ms for ms, _ in restores)
            replay_ms = sum(ms for ms, _ in replays)
            row = dict(round=rnd, snapshot_step=info["snapshot_step"],
                       replayed=info["replayed"], recover_ms=rec_ms,
                       restore_ms=restore_ms, replay_ms=replay_ms,
                       load_ms=rec_ms - restore_ms - replay_ms,
                       graph_captures=rec.stats()["graph_captures"])
            out[f"j crash {tag}"] = row
            log(f"[res] (j) crash at round {rnd} ({tag}): recovered from "
                f"snapshot {info['snapshot_step']}, {info['replayed']} "
                f"records replayed; recover {rec_ms:.1f} ms (load "
                f"{row['load_ms']:.1f}, restore {restore_ms:.1f}, replay "
                f"{replay_ms:.1f}); the recovered Engine captured "
                f"{row['graph_captures']} graphs; streams and done order "
                f"identical to the durable run's")
            del rec, dead

        # -- (a) the autotuner, path 1's geometry -------------------------
        ana = engine(autotune="analytic")
        ids_a = counted("a analytic", lambda: _res_drive(
            torch, ana, prompts, gen_len, RES_PRIOS))
        knobs = (ana.pages_per_step, ana.kv_split)
        if knobs != (8, 2) or streams_of(ana, ids_a) != want:
            raise AssertionError(f"path 9 (a): analytic knobs {knobs} "
                                 f"(expected (8, 2)) or streams differ from "
                                 f"off's")
        if ana.decode_block != 32:
            raise AssertionError(f"path 9 (a): decode_block resolved to "
                                 f"{ana.decode_block}, expected 32")
        del ana
        art = autotune._artifact_path()
        swept = None
        if autotune.load_artifact() is None:
            rows = calibrate.sweep(calibrate.SHAPES[:4])
            est, gates = calibrate.fit_and_gate(rows)
            art = autotune.save_artifact(
                est, os.path.join(tmp, "autotune.json"),
                device=calibrate.device_info(), rows=rows)
            os.environ[autotune.ARTIFACT_ENV] = str(art)
            swept = dict(rows=len(rows), gates=gates)
        est = autotune.load_estimator("fitted")
        if est.source != "artifact":
            raise AssertionError(f"path 9 (a): fitted mode read {est.source}")
        long_shape = dict(pages=257, page_size=16, hkv=1, batch=8)
        knob_rows = {}
        for name, e in (("analytic", autotune.analytic_estimator()),
                        ("fitted", est)):
            kv1 = autotune.resolve(autotune.WorkloadShape(
                pages=12, page_size=16, hkv=1, batch=8, gen_len=161), e)
            kv2 = autotune.resolve(autotune.WorkloadShape(**long_shape), e)
            knob_rows[name] = dict(path1=kv1.as_dict(), long=kv2.as_dict())
        timer = Timer(torch)
        g = torch.Generator(device=geometry["device"]).manual_seed(9)
        q, kp, vp, bt, qpos = _attention_case(torch, g, 8, 1, 4096, False,
                                              4096 + 16, torch.bfloat16)
        from repro_torch.kernels.flash_attention import paged_attention
        for name, kr in knob_rows.items():
            kv = kr["long"]
            kr["long_kernel_ms"] = timer(lambda: paged_attention(
                q, kp, vp, bt, qpos, kv_split=kv["kv_split"],
                pages_per_step=kv["pages_per_step"]))
        del timer, q, kp, vp, bt, qpos
        walls = {}
        fstreams = {}
        # in turns: analytic, fitted, fitted, analytic
        for turn, name in enumerate(("analytic", "fitted", "fitted",
                                     "analytic")):
            w = []
            eng = engine(autotune=name)
            run, counts = run_path(torch, f"path 9 a {name} {turn}", eng,
                                   prompts[:batch], gen_len, expect,
                                   walls=w)
            one_quantizer_per_qmatmul(f"path 9 a {name}", counts)
            record(f"path 9 a {name} decode {turn}", run, counts)
            got = run.pop("streams")
            if fstreams.setdefault(name, got) != got:
                raise AssertionError(f"path 9 (a) {name}: two runs gave "
                                     f"different streams")
            walls.setdefault(name, []).append(_steady(w)[0])
            knob_rows[name]["engine_knobs"] = (eng.pages_per_step,
                                               eng.kv_split)
            del eng
        # the fitted Engine is the Engine at its knobs, nothing else: its
        # streams equal an ``off`` Engine's given the same knobs, bitwise
        fk = knob_rows["fitted"]["engine_knobs"]
        eng = engine(pages_per_step=fk[0], kv_split=fk[1])
        run, counts = run_path(torch, "path 9 a explicit fitted knobs", eng,
                               prompts[:batch], gen_len, expect)
        record("path 9 a explicit fitted knobs", run, counts)
        del eng
        if run.pop("streams") != fstreams["fitted"]:
            raise AssertionError(f"path 9 (a): the fitted Engine's streams "
                                 f"differ from an off Engine's at its knobs "
                                 f"{fk}")
        # the witnesses: the same two knob vectors sum attention in the
        # same two orders under f32 compute.  With f32 weights no rounding
        # step lies between that order and the logits, so the streams are
        # gated as path 6's: a wrong kernel at the fitted knobs fails here.
        # With int8 weights the activation quantizer rounds to integer
        # codes, where an f32 difference can flip one: logged
        f32 = torch.float32
        wparams = lm.init(torch.Generator(device=geometry["device"])
                          .manual_seed(0), cfg, device=geometry["device"])
        witnesses = (("f32 weights", QuantContext(compute_dtype=f32),
                      wparams, ("paged_attention_split",), True),
                     ("int8 f32", dataclasses.replace(ctx, compute_dtype=f32),
                      params, expect, False))
        f32_parting = {}
        for wname, wctx, wp, wexpect, gated in witnesses:
            wit = {}
            for name in ("analytic", "fitted"):
                eng = Engine(cfg, wctx, wp, paged=True, **geometry,
                             autotune=name)
                run, counts = run_path(torch, f"path 9 a {wname} {name}",
                                       eng, prompts[:batch], gen_len, wexpect)
                record(f"path 9 a {wname} {name}", run, counts)
                if (eng.pages_per_step, eng.kv_split) != \
                        knob_rows[name]["engine_knobs"]:
                    raise AssertionError(
                        f"path 9 (a) {wname} {name}: knobs "
                        f"{eng.pages_per_step, eng.kv_split}")
                wit[name] = run.pop("streams")
                del eng
            f32_parting[wname] = None
            if wit["fitted"] != wit["analytic"]:
                plain = Engine(cfg, wctx, wp, paged=True, **geometry,
                               graphs=False, autotune="analytic")
                margins = plain_margins(torch, plain, prompts[:batch],
                                        wit["analytic"])
                del plain
                f32_parting[wname] = spec_gate(
                    f"path 9 (a) {wname} fitted vs analytic", wit["fitted"],
                    wit["analytic"], margins, gated=gated)
        # the loop's names hold the f32 weights too (9.3 GiB)
        del wparams, witnesses, wp, wctx
        parting = None
        if fstreams["fitted"] != fstreams["analytic"]:
            # bf16 compute: logged, the f32 run above is the gate
            tops = []
            margins = plain_margins(torch, engine(graphs=False,
                                                  autotune="analytic"),
                                    prompts[:batch], fstreams["analytic"],
                                    tops)
            parting = parting_log("path 9 (a) fitted vs analytic",
                                  fstreams["fitted"], fstreams["analytic"],
                                  margins, tops)
        out["a"] = dict(analytic_knobs=knobs, decode_block=32,
                        artifact=str(art), swept=swept,
                        fitted_weights=list(est.weights), knobs=knob_rows,
                        decode_ms_per_step=walls,
                        fitted_vs_analytic=parting,
                        f32_fitted_vs_analytic=f32_parting)
        log(f"[res] (a) analytic knobs {knobs} == off's, streams identical, "
            f"decode_block 32; fitted ({est.source}, {art}"
            f"{', swept here' if swept else ''}) picks "
            f"{knob_rows['fitted']['path1']} at path 1's geometry and "
            f"{knob_rows['fitted']['long']} at ~4096 tokens (analytic: "
            f"{knob_rows['analytic']['long']}); paged attention at ~4096 "
            f"tokens {knob_rows['analytic']['long_kernel_ms']:.4f} ms "
            f"(analytic knobs) vs {knob_rows['fitted']['long_kernel_ms']:.4f}"
            f" ms (fitted); decode block wall per step (graph replays, "
            f"two runs each, in turns) analytic "
            f"{[round(x, 3) for x in walls['analytic']]} ms, fitted "
            f"{[round(x, 3) for x in walls['fitted']]} ms; fitted streams "
            f"identical to an off Engine's at {fk}, "
            f"{'identical to' if parting is None else 'parting from'} "
            f"analytic's; under f32 compute, f32 weights "
            + ("identical" if f32_parting["f32 weights"] is None else
               f"parting only at plain margins below {SPEC_MARGIN_BOUND}")
            + ", int8 weights " + ("identical" if f32_parting["int8 f32"]
                                   is None else "parting (logged)"))
        tiled = [np.tile(p[:8], len(p) // 8 + 1)[:len(p)]
                 for p in prompts[:batch]]
        spec = {}
        for name in ("off", "analytic"):
            eng = engine(spec=True, spec_k=SPEC_K, autotune=name)
            ks = []
            orig = eng._step_many

            def step(n, eng=eng, ks=ks, orig=orig):
                r = orig(n)
                ks.append(eng.spec_k)
                return r
            eng._step_many = step
            ids8 = counted(f"a spec {name}", lambda: _res_drive(
                torch, eng, tiled, gen_len, ["standard"] * batch, block=2))
            st = eng.stats()
            spec[name] = dict(streams=streams_of(eng, ids8), spec_k=ks,
                              spec_k_rejits=st["spec_k_rejits"],
                              graph_captures=st["graph_captures"],
                              accepted_per_step=st["accepted_per_step"])
            # the wrapper and the bound method hold the Engine too
            del eng, step, orig
        if spec["analytic"]["streams"] != spec["off"]["streams"]:
            raise AssertionError("path 9 (a): the adaptive spec_k run's "
                                 "streams differ from the fixed-k run's")
        for v in spec.values():
            v.pop("streams")
        out["a"]["spec"] = spec
        log(f"[res] (a) n-gram spec, analytic: spec_k by block "
            f"{spec['analytic']['spec_k']}, {spec['analytic']['spec_k_rejits']}"
            f" switches, {spec['analytic']['graph_captures']} graphs "
            f"captured (fixed k: {spec['off']['graph_captures']}), accepted "
            f"per round {spec['analytic']['accepted_per_step']:.3f} (fixed: "
            f"{spec['off']['accepted_per_step']:.3f}); streams identical")

        # -- (f) the fleet: two replicas and a hot standby ----------------
        def fleet(tag, inj=None):
            return Fleet(lambda **kw: engine(**kw), 2,
                         standby_dir=os.path.join(tmp, f"fleet-{tag}"),
                         fault_injector=inj)

        def fleet_run(tag, inj=None):
            fl = fleet(tag, inj)
            fids = [fl.submit(p, gen_len=gen_len, priority=c)
                    for p, c in zip(prompts, RES_PRIOS)]
            fl.drain(block=8)
            torch.cuda.synchronize()
            return fl, fids

        fl0, fids = counted("f0 fleet", lambda: fleet_run("f0"))
        _res_complete("f0", fl0.results, fids, gen_len)
        f0 = {f: fl0.results[f]["tokens"] for f in fids}
        homes = {f: fl0._ledger[f]["replica"] for f in fids}
        flags = [m.events for m in fl0.monitors]
        if fl0.counters["deaths"] or fl0.counters["redispatched"]:
            raise AssertionError(f"path 9 (f0): a fault-free fleet counted "
                                 f"{fl0.counters}")
        if sorted(fl0.results) != sorted(fids):
            raise AssertionError("path 9 (f0): a fleet id did not complete "
                                 "exactly once")
        out["f0"] = dict(counters=dict(fl0.counters), rounds=fl0._round,
                         states=list(fl0.state), straggler_flags=flags,
                         suspects=fl0.counters["suspects"])
        log(f"[res] (f0) fault-free fleet: {fl0._round} rounds, states "
            f"{fl0.state}, straggler flags per replica {flags}, suspects "
            f"{fl0.counters['suspects']}, deaths 0, journal lag "
            f"{fl0.counters['journal_lag_records']}")
        del fl0
        fl1, _ = counted("f1 primary killed", lambda: fleet_run(
            "f1", FleetFaultInjector([(RES_KILL_ROUND, 0, "kill")])))
        mem("after the promotion")
        if fl1.counters["promotions"] != 1 or \
                {f: fl1.results[f]["tokens"] for f in fids} != f0:
            raise AssertionError(f"path 9 (f1): promotions "
                                 f"{fl1.counters['promotions']}, or the "
                                 f"promoted streams differ from (f0)'s")
        _res_complete("f1", fl1.results, fids, gen_len)
        out["f1"] = dict(counters=dict(fl1.counters), rounds=fl1._round,
                         graph_captures=fl1.replicas[0].stats()[
                             "graph_captures"])
        log(f"[res] (f1) primary killed at round {RES_KILL_ROUND}: 1 "
            f"promotion in {fl1.counters['time_to_promote_s'] * 1e3:.1f} ms, "
            f"journal lag {fl1.counters['journal_lag_records']} records, "
            f"streams identical to (f0)'s")
        del fl1
        fl2, _ = counted("f2 secondary killed", lambda: fleet_run(
            "f2", FleetFaultInjector([(RES_KILL_ROUND, 1, "kill")])))
        _res_complete("f2", fl2.results, fids, gen_len)
        moved = [f for f in fids if fl2._ledger[f]["redispatched"]]
        if fl2.counters["deaths"] != 1 or \
                fl2.counters["redispatched"] != len(moved) or not moved:
            raise AssertionError(f"path 9 (f2): {fl2.counters}")
        got = [fl2.results[f]["tokens"] for f in moved]
        ref = [f0[f] for f in moved]
        gate = None
        if got != ref:
            lane = [f for f in fids if homes[f] == 1]
            margins = plain_margins(torch, engine(graphs=False),
                                    [prompts[f] for f in lane],
                                    [f0[f] for f in lane])
            gate = spec_gate("path 9 (f2)", got, ref,
                             [margins[lane.index(f)] for f in moved])
        out["f2"] = dict(counters=dict(fl2.counters), moved=len(moved),
                         gate=gate)
        log(f"[res] (f2) secondary killed at round {RES_KILL_ROUND}: "
            f"{len(moved)} requests re-dispatched once, streams "
            f"{'identical to' if gate is None else 'gated against'} (f0)'s")
        del fl2

        # device busy of one fleet round against one Engine's block
        def warm(obj, submit):
            for p, c in zip(prompts, RES_PRIOS):
                submit(p, gen_len=gen_len, priority=c)
            obj.try_admit()
            obj.step_many(8)            # eager block and capture
        fl = fleet("busy")
        warm(fl, fl.submit)
        fbusy, fk = _profiled_busy(torch, lambda: fl.step_many(8))
        del fl
        one = engine()
        warm(one, one.submit)
        ebusy, ek = _profiled_busy(torch, lambda: one.step_many(8))
        del one
        out["busy"] = dict(fleet_round_ms=fbusy, fleet_kernels=fk,
                           engine_block_ms=ebusy, engine_kernels=ek)
        log(f"[res] device busy of one 8-step fleet round (2 replicas + "
            f"standby) {fmt_ms(fbusy)} ({fk} device kernels) against one "
            f"Engine's 8-step block {fmt_ms(ebusy)} ({ek})")

        # -- (q) a BATCH flood against a REALTIME floor -------------------
        need = -(-(len(prompts[0]) + gen_len) // geometry["page_size"])
        pool = int(0.7 * batch * need)
        quotas = {"realtime": {"floor": 0.25}, "batch": {"cap": 0.75}}
        eng = engine(num_pages=pool, class_quotas=quotas)
        cap = eng.allocator.cap_pages("batch")
        per_round = []

        def flood():
            for p in prompts[:8]:
                eng.submit(p, gen_len=gen_len, priority="batch")
            eng.try_admit()
            eng.step_many(8)
            rt = [eng.submit(p, gen_len=gen_len, priority="realtime")
                  for p in prompts[8:10]]
            eng.try_admit()
            while eng.live.any() or eng.waiting:
                used = {c: eng.allocator.class_used(c)
                        for c in ("realtime", "standard", "batch")}
                running = {m["priority"].name.lower()
                           for m in eng._req_meta.values()}
                queued = sum(1 for r in eng.waiting
                             if eng._rec_priority(r).name == "BATCH")
                per_round.append(dict(used=used, running=sorted(running),
                                      batch_queued=queued))
                if used["batch"] > cap:
                    raise AssertionError(f"path 9 (q): batch holds "
                                         f"{used['batch']} pages over its "
                                         f"cap {cap}")
                eng.step_many(8)
            eng.retire_finished()
            return rt

        rt = counted("q quotas", flood)
        _res_complete("q", eng.results, rt, gen_len)
        first_rt = next(i for i, r in enumerate(per_round)
                        if "realtime" in r["running"])
        if first_rt != 0 or per_round[first_rt]["batch_queued"] == 0:
            raise AssertionError(f"path 9 (q): the first realtime request "
                                 f"ran at sweep {first_rt}, flood queued "
                                 f"{per_round[first_rt]['batch_queued']}")
        admitted = {c.name.lower(): row["admitted"]
                    for c, row in eng.class_counters.items()}
        out["q"] = dict(pool=pool, quotas=quotas, cap_pages=cap,
                        floor_pages=eng.allocator.floor_pages("realtime"),
                        admitted=admitted, per_round=per_round)
        log(f"[res] (q) pool {pool} pages, realtime floor "
            f"{out['q']['floor_pages']}, batch cap {cap}: realtime running "
            f"from the first block after its submission while "
            f"{per_round[0]['batch_queued']} batch requests queue; pages "
            f"per class by block {[r['used'] for r in per_round]}; "
            f"admissions {admitted}")
        del eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.pop("REPRO_TORCH_AUTOTUNE", None)
    mem("after path 9")
    grew = (out["memory_gib"]["after path 9"]
            - out["memory_gib"]["before path 9"])
    if grew > 0.1:
        raise AssertionError(f"path 9: {grew:.3f} GiB more on the card after "
                             f"it than before (a dead Engine, or weights, "
                             f"still referenced)")
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


#: path 10: the rest of the lm family at its published widths, depth cut
#: to fit the card and the run's time (deepseek: its dense first layer and
#: one MoE layer), served as path 1 is but shorter
FAMILY = (("yi-6b", 2), ("glm4-9b", 2), ("command-r-35b", 2),
          ("olmoe-1b-7b", 2), ("deepseek-v2-236b", 2))
FAMILY_RUN = dict(batch=8, plen=128, gen=16, chunk=16, ps=16)
#: path 10's MoE configs that also run greedy n-gram speculation (a verify
#: pass gives each expert another M)
FAMILY_SPEC = ("olmoe-1b-7b", "deepseek-v2-236b")
#: the cache-free forward of path 10 (deepseek's MLA naive form and glm4)
FAMILY_FORWARD_S = 512


def _family_cfg(arch: str, depth: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=depth)


def _paged_launches(counts) -> int:
    """The Hopper paged kernel's launches (``run_path`` has held the
    control's to 0 on every run the plan does not route to it)."""
    return counts["paged_attention_split"] + counts["paged_attention_unsplit"]


def _busy_per_step(torch, eng, prompts, steps=8):
    """(decode wall ms, device busy ms, device kernels and copies) per step
    of one ``steps``-step block with every lane live: fresh requests (cut
    to fit four blocks in ``max_len``) are admitted and warmed by one
    block, then one block is timed on the host clock and one under the
    profiler (which traces it twice); the lanes are drained after."""
    plen = eng.max_len - 4 * steps - 2
    for p in prompts[:eng.batch]:
        eng.submit(p[:plen], gen_len=4 * steps + 1)
    eng.try_admit()
    eng.step_many(steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_many(steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    busy, n = _profiled_busy(torch, lambda: eng.step_many(steps))
    if not eng.live.all():
        raise AssertionError("a lane finished inside the measured blocks")
    while eng.live.any():
        eng.step_many(steps)
    eng.retire_finished()
    return wall, (None if busy is None else busy / steps), n / steps


def _cache_free_forward(torch, cfg, params, ctx, record):
    """``lm.forward`` without a cache at S 512 through the kernels and the
    plain versions: flash once per layer, logits gated as path 1's."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import prepare_params
    from repro_torch.models import lm
    tokens = torch.tensor(SyntheticLM(cfg.vocab, seed=1).tokens(
        0, 1, FAMILY_FORWARD_S)[:, :FAMILY_FORWARD_S].astype("int32"),
        device="cuda")
    pp = prepare_params(params, ctx, "cuda")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, _, aux = lm.forward(pp, tokens, cfg, ctx)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    lp, _, aux_p = lm.forward(pp, tokens, cfg,
                              dataclasses.replace(ctx, backend="ref"))
    if counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"{cfg.name} cache-free forward: "
                             f"flash_attention launched "
                             f"{counts['flash_attention']} times for "
                             f"{cfg.n_layers} layers")
    check = gate_logits(torch, "[family]", f"{cfg.name} cache-free forward "
                        f"S {FAMILY_FORWARD_S}", lk.float(), lp.float(),
                        ctx.compute_dtype)
    check.update(ms=ms, launches=counts, aux=float(aux),
                 aux_plain=float(aux_p))
    log(f"[family] {cfg.name} cache-free forward S {FAMILY_FORWARD_S}: "
        f"{ms:.1f} ms (first call, host clock), aux {float(aux):.4f} "
        f"(plain {float(aux_p):.4f}), launches {json.dumps(counts)}")
    record(counts)
    del pp, lk, lp
    return check


def serve_family(torch, report) -> dict:
    """Path 10: yi-6b, glm4-9b, command-r-35b, olmoe-1b-7b and
    deepseek-v2-236b at their published widths (depth cut, FAMILY),
    random int8 weights (the f32 tree freed after PTQ), bf16 compute,
    the paged f32 KV cache, batch 8, 8 requests, prompt 128, prefill
    chunk 16, pages of 16, 16 greedy tokens, graphed decode blocks, the
    launch counters reset before each config: every request completes;
    the GQA configs launch qmatmul, quantize_rows (one per qmatmul) and
    paged attention, deepseek qmatmul and quantize_rows and no paged
    attention (its absorbed decode attends with einsums, as the
    reference's); logits of one prefill chunk and 4 decode steps through
    the kernels against the plain versions at path 1's gates.  Logged per
    config: prefill ms per chunk, decode wall, device busy and device
    kernels per step, the card's peak memory.  Also a cache-free forward
    at S 512 of deepseek and glm4 (flash once per layer, gated),
    deepseek in blocks of 4, 8, 4 (two graphs sharing one memory pool)
    and served eagerly too (identical streams and counts), and
    olmoe under --lut --paged with bf16 weights (the standalone
    lut_activation kernel once per MoE layer and model call, gated)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.serve import Engine, quantize_for_serving
    from repro_torch.models import lm
    from repro_torch.models.lm import _split_layers
    from repro_torch.nn.context import QuantContext

    int8 = QuantContext(mode="int8",
                        policy=PrecisionPolicy.uniform(FixedPointType(8, 4)),
                        compute_dtype=torch.bfloat16)
    r = FAMILY_RUN
    batch, plen, gen_len = r["batch"], r["plen"], r["gen"]
    max_len = plen + gen_len + 1
    geometry = dict(batch=batch, max_len=max_len, prefill_chunk=r["chunk"],
                    page_size=r["ps"], device="cuda")
    out, total = {}, {}

    def record(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for arch, depth in FAMILY:
        cfg = _family_cfg(arch, depth)
        n_dense, n_moe = _split_layers(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = quantize_for_serving(lm.init(
            torch.Generator(device="cuda").manual_seed(0), cfg,
            device="cuda"), int8)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        log(f"[family] {arch}: {n_dense} dense + {n_moe} MoE layers of "
            f"{get_config(arch).n_layers} (d_model {cfg.d_model}, "
            f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab}"
            + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
               f"{cfg.moe.d_ff_expert}, {cfg.moe.n_shared} shared"
               if cfg.moe else "")
            + (f", MLA q_lora {cfg.mla.q_lora_rank} kv_lora "
               f"{cfg.mla.kv_lora_rank}" if cfg.mla else "")
            + f"); random int8 weights in {init_s:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
            f"(peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"with the f32 tree)")
        src = SyntheticLM(cfg.vocab, seed=0)
        prompts = [src.tokens(i, 1, plen)[0, :-1] for i in range(2 * batch)]
        row = dict(depth=depth, n_dense=n_dense, n_moe=n_moe, init_s=init_s)
        row["logit_checks"] = logit_check(torch, cfg, params, int8, prompts,
                                          batch, max_len, r["chunk"],
                                          r["ps"], steps=4, name=f"{arch} ")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        label = f"{arch} int8 paged"
        eng = Engine(cfg, int8, params, paged=True, **geometry)
        prefill = []
        _timed(torch, eng, "_prefill_chunked", prefill)
        walls = []
        reserved0 = torch.cuda.memory_reserved()
        # deepseek: blocks of 4, 8, 4 capture two graphs (4 and 8 steps)
        # that share one memory pool for the dequantized expert banks
        run, counts = run_path(torch, label, eng, prompts[:batch], gen_len,
                               ("qmatmul", "quantize_rows"), walls=walls,
                               first=(4,) if cfg.attn_kind == "mla" else ())
        one_quantizer_per_qmatmul(label, counts)
        paged = _paged_launches(counts)
        if cfg.attn_kind == "mla" and paged:
            raise AssertionError(f"{label}: paged attention launched {paged}"
                                 f" times; the absorbed decode has none")
        if cfg.attn_kind != "mla" and not paged:
            raise AssertionError(f"{label}: paged attention never launched")
        record(counts)
        wall, busy, kernels = _busy_per_step(torch, eng, prompts[batch:])
        steady = [w / n for w, _, _, n, cap in walls if not cap]
        row.update(
            run=run, prefill_ms=sum(ms for ms, _ in prefill),
            prefill_chunks=run["prefill_chunks"],
            prefill_ms_per_chunk=(sum(ms for ms, _ in prefill)
                                  / max(1, run["prefill_chunks"])),
            decode_wall_ms_per_step_run=(statistics.median(steady)
                                         if steady else None),
            decode_wall_ms_per_step=wall, device_busy_ms_per_step=busy,
            device_kernels_per_step=kernels,
            graph_captures=eng.blocks.captures,
            max_memory_allocated_gib=torch.cuda.max_memory_allocated()
            / 2**30, memory_reserved_gib=torch.cuda.memory_reserved()
            / 2**30, serving_reserved_gib=(torch.cuda.memory_reserved()
                                           - reserved0) / 2**30)
        log(f"[family] {label}: prefill {row['prefill_ms_per_chunk']:.2f} ms"
            f" per chunk ({run['prefill_chunks']} chunks of {batch} x "
            f"{r['chunk']}), decode wall {wall:.3f} ms per step, device busy"
            f" {fmt_ms(busy)} per step, {kernels:.1f} device kernels and "
            f"copies per step, {eng.blocks.captures} graphs captured (one "
            f"shared pool), peak memory "
            f"{row['max_memory_allocated_gib']:.2f} GiB allocated, "
            f"{row['memory_reserved_gib']:.2f} GiB reserved "
            f"({row['serving_reserved_gib']:+.2f} GiB over the run)")
        if cfg.attn_kind == "mla":
            # the same requests served eagerly: identical streams, counts
            eager = Engine(cfg, int8, params, paged=True, graphs=False,
                           **geometry)
            erun, ecounts = run_path(torch, f"{arch} int8 paged, eager",
                                     eager, prompts[:batch], gen_len,
                                     ("qmatmul", "quantize_rows"),
                                     first=(4,))
            if erun["streams"] != run["streams"] or ecounts != counts:
                raise AssertionError(f"{arch}: eager streams or launch "
                                     f"counts differ from the graphed run "
                                     f"({ecounts} vs {counts})")
            log(f"[family] {arch}: graphed and eager streams and launch "
                f"counts identical")
            record(ecounts)
            row["eager_identical"] = True
            del eager
        if arch in FAMILY_SPEC:
            row["spec"] = _family_spec(torch, cfg, int8, params, geometry,
                                       prompts[:batch], gen_len,
                                       run["streams"], record)
        run.pop("streams", None)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        if arch in ("glm4-9b", "deepseek-v2-236b"):
            row["cache_free_forward"] = _cache_free_forward(
                torch, cfg, params, int8, record)
        del params
        if arch == "olmoe-1b-7b":
            row["lut"] = _family_lut(torch, cfg, geometry, prompts[:batch],
                                     gen_len, r, record)
        out[arch] = row
        gc.collect()
        torch.cuda.empty_cache()
    report["family"] = out
    log(f"[family] path 10 launches: {json.dumps(total)}")
    return total


def _family_lut(torch, cfg, geometry, prompts, gen_len, r, record):
    """olmoe under ``--lut --paged`` with bf16 weights: the experts' SiLU
    through the standalone lut_activation kernel, once per MoE layer and
    model call; logits gated against the plain versions."""
    from repro_torch.launch.serve import Engine
    from repro_torch.models import lm
    from repro_torch.models.lm import _split_layers
    from repro_torch.nn.context import QuantContext
    lutf = QuantContext(mode="none", use_lut=True,
                        compute_dtype=torch.bfloat16)
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                     dtype=torch.bfloat16, device="cuda")
    checks = logit_check(torch, cfg, params, lutf, prompts,
                         geometry["batch"], geometry["max_len"], r["chunk"],
                         r["ps"], steps=4, name=f"{cfg.name} ")
    label = f"{cfg.name} --lut --paged, bf16 weights"
    eng = Engine(cfg, lutf, params, paged=True, **geometry)
    run, counts = run_path(torch, label, eng, prompts, gen_len,
                           ("lut_activation",))
    n_moe = _split_layers(cfg)[1]
    want = n_moe * (run["decode_steps"] + run["prefill_chunks"])
    stray = {k: counts[k] for k in ("lut_gated_mul", "qmatmul",
                                    "quantize_rows") if counts[k]}
    if counts["lut_activation"] != want or stray or not _paged_launches(
            counts):
        raise AssertionError(
            f"{label}: lut_activation launched {counts['lut_activation']} "
            f"times, expected {n_moe} MoE layers x ({run['decode_steps']} "
            f"decode steps + {run['prefill_chunks']} prefill chunks) = "
            f"{want}; paged attention {_paged_launches(counts)}; expected "
            f"no {sorted(stray)} launches")
    log(f"[family] {label}: lut_activation {counts['lut_activation']} "
        f"launches = {n_moe} MoE layers x ({run['decode_steps']} + "
        f"{run['prefill_chunks']}) model calls")
    record(counts)
    run.pop("streams", None)
    del eng, params
    return dict(logit_checks=checks, run=run)


def gate_streams(torch, label, streams, plain, make_plain, prompts):
    """Greedy streams against the plain run's: identical, or parting only
    where the plain Engine's own top-2 margin is below SPEC_MARGIN_BOUND
    (path 6's gate; the margins are replayed, on ``make_plain()``, only
    when a stream parts).  Returns the partings."""
    if streams == plain:
        log(f"[spec] {label}: streams identical to the plain run's")
        return []
    margins = plain_margins(torch, make_plain(), prompts, plain)
    return spec_gate(label, streams, plain, margins)


def _family_spec(torch, cfg, ctx, params, geometry, prompts, gen_len, plain,
                 record):
    """Path 10's MoE configs with n-gram speculation (spec_k 4, greedy,
    graphed) on path 10's prompts: a verify pass gives each expert
    another M; streams gated against the plain run's as path 6's."""
    from repro_torch.launch.serve import Engine
    label = f"{cfg.name} int8 paged, ngram spec k {SPEC_K}"
    eng = Engine(cfg, ctx, params, paged=True, spec=True, spec_k=SPEC_K,
                 **geometry)
    run, counts = run_path(torch, label, eng, prompts, gen_len,
                           ("qmatmul", "quantize_rows"))
    one_quantizer_per_qmatmul(label, counts)
    record(counts)
    st = eng.stats()
    accepted = eng.counters["draft_accepted"] / max(
        1, eng.counters["verify_steps"])
    parting = gate_streams(torch, label, run.pop("streams"), plain,
                           lambda: Engine(cfg, ctx, params, paged=True,
                                          **geometry), prompts)
    log(f"[family] {label}: {accepted:.3f} drafts accepted per live round, "
        f"{st['graph_captures']} graphs captured")
    del eng
    return dict(run=run, accepted_per_round=accepted, parting=parting)


#: path 11: the recurrent families at their published widths and depths;
#: batch 8, 8 requests, prompt 64, 32 greedy tokens, blocks of 8
RECURRENT = ("mamba2-370m", "zamba2-1.2b")
RECURRENT_RUN = dict(batch=8, plen=64, gen=32, ps=16)
#: (f): the step builders' whole-prompt prefill (mamba2) and the cache-free
#: forward (zamba2) at this length: two SSD chunks of 256
RECURRENT_FORWARD_S = 512


def _state_bytes_per_lane(eng) -> int:
    """Bytes of one lane's recurrent state (every layer's conv window and
    SSM state)."""
    from repro_torch.models.api import cache_leaves, spec_state_fn
    return sum(t[0].numel() * t.element_size() for _, t in
               cache_leaves(spec_state_fn(eng.cache, eng.cfg)))


def recurrent_logit_check(torch, cfg, params, ctx, prompts, geometry,
                          paged, *, steps: int):
    """Full-width logits of a whole-prompt prefill and ``steps`` teacher-
    forced decode steps through the kernels and through the plain versions
    (the recurrent families' ``prefill`` / ``decode_step``, on the
    serving cache of the path: mamba2's dense state, zamba2's paged KV at
    the auto knobs), gated as path 1's."""
    from repro_torch.kernels.flash_attention import _resolve_knobs
    from repro_torch.launch.serve import prepare_params
    from repro_torch.models.api import get_family, set_block_table
    fam = get_family(cfg)
    batch, max_len, ps = (geometry["batch"], geometry["max_len"],
                          geometry["page_size"])
    ctxs = {"kernels": ctx, "plain": dataclasses.replace(ctx, backend="ref")}
    if paged:
        width = -(-(max_len + 1) // ps)
        t, split = _resolve_knobs(width, ps, cfg.n_kv_heads, batch, None,
                                  None)
        ctxs = {k: dataclasses.replace(c, kv_split=split, pages_per_step=t)
                for k, c in ctxs.items()}
        num_pages = batch * (-(-max_len // ps))
        bt = torch.full((batch, width), num_pages, dtype=torch.int32)
        bt[:, :num_pages // batch] = torch.arange(
            num_pages, dtype=torch.int32).reshape(batch, -1)
    pp = prepare_params(params, ctx, "cuda")
    tokens = torch.tensor(np_stack(prompts[:batch]), device="cuda")
    pos = torch.zeros((batch,), dtype=torch.int32, device="cuda")
    caches = {}
    for name in ctxs:
        if paged:
            caches[name] = fam.init_paged_cache(cfg, batch, num_pages, ps,
                                                width, torch.float32, "cuda")
            set_block_table(caches[name], bt.cuda())
        else:
            caches[name] = fam.init_cache(cfg, batch, max_len,
                                          torch.float32, "cuda")
    mode = f"{cfg.name} {ctx.mode}{' +lut' if ctx.use_lut else ''}"
    checks = []
    for step in range(steps + 1):
        logits = {}
        for name, c in ctxs.items():
            if step == 0:
                logits[name], _ = fam.prefill(pp, tokens, caches[name], cfg,
                                              c, pos=pos, full_logits=True)
            else:
                logits[name], _ = fam.decode_step(pp, tokens, caches[name],
                                                  pos, cfg, c)
        lp = logits["plain"].float()
        checks.append(gate_logits(
            torch, "[recurrent]", f"{mode}: " + (
                f"whole-prompt prefill S {tokens.shape[1]}" if step == 0
                else f"decode step {step}"),
            logits["kernels"].float(), lp, ctx.compute_dtype))
        pos = pos + tokens.shape[1]
        tokens = lp[:, -1].argmax(-1).to(torch.int32)[:, None]
    del pp, caches
    torch.cuda.synchronize()
    return checks


def _recurrent_engine_run(torch, label, eng, prompts, gen_len, expect, *,
                          paged_expected, record, ids=None):
    """One path 11 run through ``run_path`` (blocks of 8, the third block
    traced for device busy; ``ids``: an engine admitted or restored
    already): the looped prefill timed per admission, the kernels of the
    path required (paged attention on the hybrid's paged cache, never on
    mamba2), one graph per (steps, sampled)."""
    prefill, walls, busy = [], [], []
    _timed(torch, eng, "_prefill_looped", prefill)
    run, counts = run_path(torch, label, eng, prompts, gen_len, expect,
                           walls=walls, busy=busy, ids=ids)
    if "qmatmul" in expect:
        one_quantizer_per_qmatmul(label, counts)
    paged = _paged_launches(counts)
    if paged_expected and not paged:
        raise AssertionError(f"{label}: paged attention never launched")
    if not paged_expected and paged:
        raise AssertionError(f"{label}: paged attention launched {paged} "
                             f"times on a cache without pages")
    if eng.blocks.graphs and eng.blocks.captures != 1:
        raise AssertionError(f"{label}: {eng.blocks.captures} graphs "
                             f"captured, expected one per (steps, sampled)")
    record(counts)
    steady = [w / n for w, _, _, n, cap in walls if not cap]
    run.update(
        prefill_ms_per_admission=[ms for ms, _ in prefill],
        decode_wall_ms_per_step=(statistics.median(steady) if steady
                                 else None),
        device_busy_ms_per_step=busy[0][0] if busy else None,
        device_kernels_per_step=busy[0][1] if busy else None,
        state_bytes_per_lane=_state_bytes_per_lane(eng),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    admissions = (", ".join(f"{ms:.0f}" for ms in
                            run["prefill_ms_per_admission"]) + " ms"
                  if prefill else "none here (admitted or restored before)")
    log(f"[recurrent] {label}: looped prefill {admissions} per admission "
        f"({len(prompts)} prompts of {len(prompts[0])}), "
        f"decode wall {fmt_ms(run['decode_wall_ms_per_step'])} per step, "
        f"device busy {fmt_ms(run['device_busy_ms_per_step'])} per step, "
        f"{run['device_kernels_per_step'] or 0:.1f} device kernels and "
        f"copies per step, state {run['state_bytes_per_lane'] / 2**20:.2f} "
        f"MiB per lane, peak memory "
        f"{run['max_memory_allocated_gib']:.2f} GiB allocated")
    return run, counts


def _xla_left_ops(torch, cfg, params, ctx, batch, report_row):
    """Device time of what the reference leaves to XLA, at path 11's
    shapes, beside its bound: the decode step's state update
    (``decode_state_step``, batch 8) for one layer with a cold L2 (CUDA
    events), and for every mamba layer of a step, each on its own state,
    as one CUDA graph replay (the decode step's own conditions); the
    whole-prompt SSD (``ssd_scan``, batch 8, S RECURRENT_FORWARD_S) per
    layer, cold, and per prefill, times the mamba layers."""
    from repro_torch.nn.blocks import layer_slice
    from repro_torch.nn.ssm import decode_state_step, mamba2_state_spec, \
        ssd_scan
    d = cfg.ssm
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(5)
    stack = params["layers"] if cfg.family == "ssm" else \
        layer_slice(params["groups"], 0)
    p = layer_slice(stack, 0)["ssm"]
    state = mamba2_state_spec(d, batch, "cuda")
    xbc = torch.randn((batch, d.conv_dim), generator=g, device="cuda") \
        .to(ctx.compute_dtype)
    dt = torch.randn((batch, d.n_heads), generator=g, device="cuda") \
        .to(ctx.compute_dtype)
    dec_ms = timer(lambda: decode_state_step(p, xbc, dt, state, d, ctx))
    # bytes: the state read and written, the new conv column and dt in
    # (compute dtype), y out (f32), the layer's conv and head parameters
    st_bytes = sum(t.numel() * 4 for t in state.values())
    el = xbc.element_size()
    dec_bytes = (2 * st_bytes + (xbc.numel() + dt.numel()) * el
                 + batch * d.d_inner * 4
                 + (d.d_conv + 1) * d.conv_dim * 4 + 3 * d.n_heads * 4)
    dec_ops = batch * (2 * d.d_conv * d.conv_dim
                       + 4 * d.n_heads * d.d_state * d.head_dim)
    dec_bound, dec_by = bound_ms(dec_bytes, dec_ops, F32_FLOP_PER_S)
    layers = cfg.n_layers
    states = [mamba2_state_spec(d, batch, "cuda") for _ in range(layers)]

    def every_layer():
        for st in states:
            decode_state_step(p, xbc, dt, st, d, ctx)
    every_layer()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        every_layer()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 10
    del graph, states
    s = RECURRENT_FORWARD_S
    q = min(d.chunk, s)
    xbc_s = torch.randn((batch, s, d.conv_dim), generator=g,
                        device="cuda").to(ctx.compute_dtype)
    dt_s = torch.randn((batch, s, d.n_heads), generator=g,
                       device="cuda").to(ctx.compute_dtype)
    ssd_ms = timer(lambda: ssd_scan(p, xbc_s, dt_s, d, ctx), reps=5)
    ph, n, hd = d.n_heads, d.d_state, d.head_dim
    ssd_bytes = ((xbc_s.numel() + dt_s.numel()) * el + batch * s * d.d_inner
                 * 4 + batch * ph * n * hd * 4)
    # scores, y_intra (causal half of the q x q pairs), chunk states, y_inter
    pairs = batch * (s // q) * q * (q + 1) // 2 * ph
    ssd_ops = 2.0 * pairs * (n + hd) + 4.0 * batch * s * ph * n * hd
    ssd_bound, ssd_by = bound_ms(ssd_bytes, ssd_ops, F32_FLOP_PER_S)
    row = dict(decode_state_ms_per_layer_cold=dec_ms,
               decode_state_ms_per_step_graph=step_ms,
               decode_state_bound_ms_per_layer=dec_bound,
               decode_state_bound_by=dec_by,
               ssd_scan_ms_per_layer=ssd_ms,
               ssd_scan_ms_per_prefill=ssd_ms * layers,
               ssd_scan_bound_ms_per_layer=ssd_bound, ssd_scan_bound_by=ssd_by,
               layers=layers, batch=batch, s=s)
    report_row["xla_left_ops"] = row
    log(f"[recurrent] {cfg.name} ops the reference leaves to XLA (PyTorch "
        f"ops here, no kernel): decode-state update {dec_ms:.4f} ms for one "
        f"layer (cold L2), {step_ms:.3f} ms for the {layers} layers of a "
        f"decode step as one graph replay (bound {dec_bound:.5f} ms per "
        f"layer, {dec_by}); SSD scan at B {batch} S "
        f"{s} {ssd_ms:.3f} ms per layer x {layers} = {ssd_ms * layers:.1f} "
        f"ms per prefill (bound {ssd_bound:.4f} ms per layer, {ssd_by})")
    del timer


def serve_recurrent(torch, report) -> dict:
    """Path 11: mamba2-370m (``ssm``) and zamba2-1.2b (``hybrid``) at their
    published widths and full depth, random weights from a seeded
    generator on the card, bf16 compute, batch 8, 8 requests, prompt 64,
    32 greedy tokens, graphed blocks of 8, through the Engine (the looped
    prefill: one full-batch decode step per prompt token):

    (a) mamba2 ``--quant int8``, dense state; (b) zamba2 ``--quant int8
    --paged`` (f32 KV, pages of 16, auto knobs); both also served eagerly
    (identical streams and counts) and with n-gram speculation (d,
    ``spec_k`` 4: n-gram, and a chain drafter proposing (a)/(b)'s streams,
    gated against them as path 6's; the eager and speculative runs restore
    (a)/(b)'s snapshot taken after its admission); (e) zamba2 (b) with
    ``preempt`` over a pool of 70% of 8 lanes' budgets (lanes spill their
    pages and SSM lanes and resume; gated as (d)); (c) mamba2 ``--lut``
    and zamba2 ``--lut --paged`` with bf16 weights; (f) mamba2's
    whole-prompt prefill through the step builders and zamba2's cache-free
    forward at S 512 (flash once per application point), kernels against
    plain versions.  Logits of a whole-prompt prefill and 4 decode steps
    are gated as path 1's for (a), (b) and (c).  Logged: looped prefill
    ms per admission, decode wall, device busy and kernels per step,
    state bytes per lane and peak memory, spec round busy, spill and
    resume ms, and the device time of the ops the reference leaves to
    XLA (the SSD scan, the decode-state update)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import (Engine, prepare_params,
                                          quantize_for_serving)
    from repro_torch.models.api import get_family
    from repro_torch.nn.context import QuantContext
    from repro_torch.train.step import build_prefill_step

    int8 = QuantContext(mode="int8",
                        policy=PrecisionPolicy.uniform(FixedPointType(8, 4)),
                        compute_dtype=torch.bfloat16)
    lutf = QuantContext(mode="none", use_lut=True,
                        compute_dtype=torch.bfloat16)
    r = RECURRENT_RUN
    batch, plen, gen_len = r["batch"], r["plen"], r["gen"]
    max_len = plen + gen_len + 1
    geometry = dict(batch=batch, max_len=max_len, page_size=r["ps"],
                    device="cuda")
    out, total = {}, {}

    def record(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for arch in RECURRENT:
        cfg = get_config(arch)
        fam = get_family(cfg)
        hybrid = cfg.family == "hybrid"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = quantize_for_serving(fam.init(
            torch.Generator(device="cuda").manual_seed(0), cfg,
            device="cuda"), int8)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        log(f"[recurrent] {arch}: {cfg.n_layers} mamba layers (d_model "
            f"{cfg.d_model}, d_state {cfg.ssm.d_state}, {cfg.ssm.n_heads} "
            f"SSD heads of {cfg.ssm.head_dim}, vocab {cfg.vocab}"
            + (f", shared block every {cfg.shared_attn_every}: "
               f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
               f"d_ff {cfg.d_ff}" if hybrid else "")
            + f"), {cfg.n_params() / 1e9:.3f} B params; random int8 weights "
            f"in {init_s:.1f}s, {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB on the card (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB with the f32 tree)")
        src = SyntheticLM(cfg.vocab, seed=0)
        prompts = [src.tokens(i, 1, plen)[0, :-1] for i in range(batch)]
        row = dict(layers=cfg.n_layers, init_s=init_s)
        row["logit_checks"] = recurrent_logit_check(
            torch, cfg, params, int8, prompts, geometry, hybrid, steps=4)
        expect = ("qmatmul", "quantize_rows")
        kind = "int8 paged" if hybrid else "int8 dense"

        def make(**kw):
            return Engine(cfg, int8, params, paged=hybrid, **geometry, **kw)

        # -- (a) / (b): one admission (the looped prefill), snapshotted;
        # the eager and speculative runs restore it into their engines
        base = make()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [base.submit(p, gen_len=gen_len) for p in prompts]
        base.try_admit()
        torch.cuda.synchronize()
        admit_ms = (time.perf_counter() - t0) * 1e3
        admit_counts = launch_counts()
        record(admit_counts)
        snap = base.snapshot()
        log(f"[recurrent] {arch} {kind}: looped prefill {admit_ms:.0f} ms "
            f"per admission ({batch} prompts of {plen}: {batch * plen} "
            f"full-batch eager decode steps), launches "
            f"{json.dumps(admit_counts)}")

        def restored(**kw):
            eng = make(**kw)
            eng.restore(snap)
            return eng

        torch.cuda.reset_peak_memory_stats()
        run, counts = _recurrent_engine_run(
            torch, f"{arch} {kind}", base, prompts, gen_len, expect,
            paged_expected=hybrid, record=record, ids=ids)
        plain = run.pop("streams")
        run.update(prefill_ms_per_admission=[admit_ms],
                   admission_launches=admit_counts)
        row["run"] = run
        # four 8-step blocks, as the graphed run (whose last two are traced)
        erun, ecounts = run_path(torch, f"{arch} {kind}, eager",
                                 restored(graphs=False), prompts, gen_len,
                                 expect, ids=ids)
        if erun.pop("streams") != plain or ecounts != counts:
            raise AssertionError(f"{arch}: eager streams or launch counts "
                                 f"differ from the graphed run ({ecounts} "
                                 f"vs {counts})")
        log(f"[recurrent] {arch} {kind}: graphed and eager streams and "
            f"launch counts identical")
        record(ecounts)
        # -- (d) speculation: n-gram, and a drafter proposing (a)/(b)'s
        # streams (every draft accepted: the rollback to a late checkpoint)
        row["spec"] = {}
        for name, kw in (("ngram", {}), ("chain", dict(
                drafter_fn=chain_drafter(torch, plain, plen)))):
            spec = restored(spec=True, spec_k=SPEC_K, **kw)
            srun, _ = _recurrent_engine_run(
                torch, f"{arch} {kind}, {name} spec k {SPEC_K}", spec,
                prompts, gen_len, expect, paged_expected=hybrid,
                record=record, ids=ids)
            srun["parting"] = gate_streams(
                torch, f"path 11 {arch} {name} spec", srun.pop("streams"),
                plain, make, prompts)
            srun["accepted_per_round"] = spec.counters[
                "draft_accepted"] / max(1, spec.counters["verify_steps"])
            log(f"[recurrent] {arch} {name} spec: "
                f"{srun['accepted_per_round']:.3f} drafts accepted per live "
                f"round, device busy "
                f"{fmt_ms(srun['device_busy_ms_per_step'])} per round")
            if name == "chain" and srun["accepted_per_round"] < 3.0:
                raise AssertionError(f"{arch} chain drafter: "
                                     f"{srun['accepted_per_round']:.3f} "
                                     f"drafts accepted per round, < 3")
            row["spec"][name] = srun
            del spec
        del base, snap
        # -- (e) preempt-and-spill over 70% of the pages ----------------
        if hybrid:
            pool = int(0.7 * batch * (-(-max_len // r["ps"])))
            eng = make(preempt=True, preempt_after=1, num_pages=pool)
            spills, resumes = [], []
            _timed(torch, eng, "_preempt", spills)
            _timed(torch, eng, "_resume", resumes)
            prun, _ = _recurrent_engine_run(
                torch, f"{arch} {kind}, preempt over {pool} pages", eng,
                prompts, gen_len, expect, paged_expected=True,
                record=record)
            if not eng.counters["preemptions"]:
                raise AssertionError(f"{arch} (e): no preemption over "
                                     f"{pool} pages")
            prun["parting"] = gate_streams(
                torch, f"path 11 {arch} preempt", prun.pop("streams"), plain,
                make, prompts)
            prun.update(preemptions=eng.counters["preemptions"],
                        spill_ms=[ms for ms, _ in spills],
                        resume_ms=[ms for ms, _ in resumes])
            log(f"[recurrent] {arch} (e): {eng.counters['preemptions']} "
                f"preemptions, spill {_mean(prun['spill_ms']):.2f} ms and "
                f"resume {_mean(prun['resume_ms']):.2f} ms a lane (mean; "
                f"pages and the SSM lane through the host)")
            row["preempt"] = prun
            del eng
        _xla_left_ops(torch, cfg, params, int8, batch, row)
        # -- (f) whole-prompt prefill / cache-free forward at S 512 -----
        tokens = torch.tensor(np_stack([
            src.tokens(i, 1, RECURRENT_FORWARD_S)[0, :-1]
            for i in range(batch)]), device="cuda")
        pp = prepare_params(params, int8, "cuda")
        logits = {}
        for name, c in (("kernels", int8),
                        ("plain", dataclasses.replace(int8, backend="ref"))):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if hybrid:
                lg, _ = fam.forward(pp, tokens, cfg, c)
                what = "cache-free forward"
            else:
                cache = fam.init_cache(cfg, batch, 0, torch.float32, "cuda")
                lg, _ = build_prefill_step(cfg, c)(pp, {"tokens": tokens},
                                                   cache)
                what = "step builders' whole-prompt prefill"
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if name == "kernels":
                counts_f, ms_f = launch_counts(), ms
            logits[name] = lg[:, -1].float()
            del lg
        groups = cfg.n_layers // cfg.shared_attn_every if hybrid else 0
        if counts_f["flash_attention"] != groups or not counts_f["qmatmul"]:
            raise AssertionError(f"{arch} {what} S {RECURRENT_FORWARD_S}: "
                                 f"flash_attention {counts_f}, expected "
                                 f"{groups} (one per application point)")
        one_quantizer_per_qmatmul(f"{arch} (f)", counts_f)
        record(counts_f)
        row["forward"] = dict(what=what, ms=ms_f, launches=counts_f,
                              check=gate_logits(
                                  torch, "[recurrent]", f"{arch} {what} S "
                                  f"{RECURRENT_FORWARD_S}, last position",
                                  logits["kernels"], logits["plain"],
                                  torch.bfloat16))
        log(f"[recurrent] {arch} (f) {what} B {batch} S "
            f"{RECURRENT_FORWARD_S}: {ms_f:.1f} ms (first call, host "
            f"clock), launches {json.dumps(counts_f)}")
        del pp, params, logits
        gc.collect()
        torch.cuda.empty_cache()
        # -- (c) --lut with bf16 weights ---------------------------------
        lparams = fam.init(torch.Generator(device="cuda").manual_seed(0),
                           cfg, dtype=torch.bfloat16, device="cuda")
        lchecks = recurrent_logit_check(torch, cfg, lparams, lutf, prompts,
                                        geometry, hybrid, steps=4)
        lexpect = ("lut_activation",) + (("lut_gated_mul",) if hybrid
                                         else ())
        lrun, lcounts = _recurrent_engine_run(
            torch, f"{arch} --lut{' --paged' if hybrid else ''}, bf16 "
            f"weights", Engine(cfg, lutf, lparams, paged=hybrid, **geometry),
            prompts, gen_len, lexpect, paged_expected=hybrid, record=record)
        if lcounts["qmatmul"] or lcounts["quantize_rows"]:
            raise AssertionError(f"{arch} --lut: int8 kernels launched with "
                                 f"bf16 weights ({lcounts})")
        lrun.pop("streams")
        row["lut"] = dict(run=lrun, logit_checks=lchecks)
        del lparams
        out[arch] = row
        gc.collect()
        torch.cuda.empty_cache()
    report["recurrent"] = out
    log(f"[recurrent] path 11 launches: {json.dumps(total)}")
    return total


#: path 12: llama-3.2-vision-11b, batch 8, a 64-token prompt, 32 greedy
#: tokens in graphed blocks of 8; (c) the cache-free forward at B 4, S 512
VLM = dict(batch=8, plen=64, gen=32, block=8, forward_b=4, forward_s=512,
           logit_steps=4)
#: path 12's second gate, beside path 1's, on the int8 run (a): the
#: relative L2 error of the logits through the kernels against the plain
#: versions'.  Every kernel of that path is bitwise its plain version
#: (qmatmul and quantize_rows), so the sound readings are 0; the image
#: moves random-weight logits far less than path 1's 0.25 allows (the
#: reference's stub image is 0.02 x randn and its K/V projections take no
#: norm), so the planted faults are held to this gate.  (b)'s plain side
#: runs the reference's table pass (f32 table values), not the kernel's
#: (the input's dtype): not bitwise in bf16, so (b) keeps path 1's gates
VLM_TOL_REL = 1e-4
VLM_FAULTS = ("zeroed img_embed", "swapped cross K/V of groups 0 and 1")


def _vlm_gates(torch, params, seed: int) -> None:
    """The eight cross blocks' gates drawn nonzero from ``seed`` (uniform
    in +-[0.3, 1.0]): at the reference's init they are 0, where the cross
    layers add nothing and no gate could see the image."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for name in ("gate_attn", "gate_mlp"):
        t = params["cross"][name]
        mag = torch.rand(t.shape, generator=g, device="cuda") * 0.7 + 0.3
        sign = torch.randint(0, 2, t.shape, generator=g, device="cuda") * 2 - 1
        params["cross"][name] = (mag * sign).float()


def vlm_logit_check(torch, cfg, params, ctx, batch, *, steps: int,
                    faults: bool):
    """Full-width logits of the prefill (every prompt position) and
    ``steps`` teacher-forced decode steps (the plain side's argmax),
    through the kernels and through the plain versions, each on its own
    dense f32 cache: gated at path 1's gates and, with ``faults``, at
    VLM_TOL_REL.  Then each planted fault of VLM_FAULTS, in the kernels'
    run only, must fail the VLM_TOL_REL gate at some step: the image
    reaches the logits, and each group reads its own cross K/V."""
    from repro_torch.models import vlm
    b, plen = batch["tokens"].shape

    def run(c, forced=None, fault=None):
        cache = vlm.init_cache(cfg, b, plen + steps + 1, torch.float32,
                               "cuda")
        bt = batch
        if fault == VLM_FAULTS[0]:
            bt = dict(batch, img_embed=torch.zeros_like(batch["img_embed"]))
        out, toks = [], []
        for step in range(steps + 1):
            if step == 0:
                logits, cache = vlm.prefill(params, bt, cache, cfg, c,
                                            full_logits=True)
                if fault == VLM_FAULTS[1]:
                    for t in cache["cross_kv"].values():
                        t[[0, 1]] = t[[1, 0]].clone()
            else:
                pos = torch.full((b,), plen + step - 1, dtype=torch.int32,
                                 device="cuda")
                tok = (toks if forced is None else forced)[step - 1]
                logits, cache = vlm.decode_step(params, tok, cache, pos, cfg,
                                                c)
            out.append(logits.float())
            toks.append(out[-1][:, -1].argmax(-1).to(torch.int32)[:, None])
        del cache
        return out, toks

    def what(step):
        return "prefill" if step == 0 else f"decode step {step}"

    mode = f"{ctx.mode}{' +lut' if ctx.use_lut else ''}"
    plain, forced = run(dataclasses.replace(ctx, backend="ref"))
    got, _ = run(ctx, forced)
    checks = []
    for step, (lk, lp) in enumerate(zip(got, plain)):
        checks.append(gate_logits(torch, "[vlm]", f"vlm {mode}: {what(step)}",
                                  lk, lp, ctx.compute_dtype))
        if faults and checks[-1]["rel_l2_err"] > VLM_TOL_REL:
            raise AssertionError(f"vlm {mode} {what(step)}: relative L2 "
                                 f"error {checks[-1]['rel_l2_err']} > "
                                 f"{VLM_TOL_REL} on a path whose kernels "
                                 f"are bitwise their plain versions")
    del got
    for fault in VLM_FAULTS if faults else ():
        got, _ = run(ctx, forced, fault)
        readings = [logit_readings(lk, lp) for lk, lp in zip(got, plain)]
        del got
        caught = [r for r in readings if not passes_gate(
            r, tol_rel=VLM_TOL_REL, min_agree=LOGIT_MIN_AGREE)]
        worst_rel = max(r["rel_l2_err"] for r in readings)
        worst_agree = min(r["argmax_agree"] for r in readings)
        by_step = ", ".join(f"{r['rel_l2_err']:.3g}" for r in readings)
        log(f"[vlm] planted fault '{fault}' ({mode}): relative L2 "
            f"{by_step} by step, argmax agreement down to "
            f"{worst_agree:.4f}; fails the gate (relative L2 <= "
            f"{VLM_TOL_REL}) at {len(caught)} of {len(readings)} steps")
        if not caught:
            raise AssertionError(f"vlm {mode}: the logit gate does not "
                                 f"catch the planted fault '{fault}'")
        checks.append(dict(step=f"planted fault: {fault}",
                           rel_l2_err=worst_rel, argmax_agree=worst_agree,
                           rel_l2_by_step=[r["rel_l2_err"] for r in readings],
                           steps_caught=len(caught)))
    del plain
    torch.cuda.synchronize()
    return checks


def _vlm_expected(cfg, mode: str, use_lut: bool, steps: int) -> dict:
    """Launches of one prefill and ``steps`` decode steps: int8 weights
    run qmatmul (and one quantize_rows each) 7 times per self layer and
    per cross layer at prefill (the image's K/V among them), 5 times per
    cross layer at decode (its K/V come from the cache); --lut with float
    weights runs lut_gated_mul once per MLP; no attention kernel (the
    dense cache and the cached cross K/V attend with einsums)."""
    from repro_torch.models import vlm
    n_groups, k_self = vlm._group_structure(cfg)
    want = {}
    if mode == "int8":
        q = 7 * n_groups * (k_self + 1) + steps * n_groups * (7 * k_self + 5)
        want = {"qmatmul": q, "quantize_rows": q}
    elif use_lut:
        want = {"lut_gated_mul": cfg.n_layers * (1 + steps)}
    return want


def _vlm_serve(torch, cfg, ctx, params, batch, blocks, cache):
    """The step builders' prefill into ``cache``, then ``gen // block``
    decode blocks of ``blocks`` (a ``DecodeBlocks``): (streams (B, gen),
    host seconds of each block)."""
    import numpy as np
    from repro_torch.train.step import build_prefill_step
    v = VLM
    b, plen, gen, blk = v["batch"], v["plen"], v["gen"], v["block"]
    logits, cache = build_prefill_step(cfg, ctx)(params, batch, cache)
    tok = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None] \
        .cpu().numpy()
    pos, live = np.full((b,), plen, np.int32), np.ones((b,), bool)
    out, walls = [], []
    for i in range(gen // blk):
        state = blocks.pack(tok, pos, live, np.full((b,), plen + gen,
                                                    np.int32),
                            np.zeros((b,), np.float32),
                            np.zeros((b,), np.int32), i * blk, -1)
        t0 = time.perf_counter()
        block, _, tok, pos, live, fault = blocks.unpack(
            blocks(params, cache, state, None, blk), blk)
        walls.append(time.perf_counter() - t0)
        if fault.any():
            raise AssertionError("vlm: non-finite logits in a decode block")
        out.append(block)
    streams = np.concatenate(out).T
    if not (streams.shape == (b, gen) and streams.min() >= 0
            and streams.max() < cfg.vocab and not live.any()):
        raise AssertionError(f"vlm: streams {streams.shape} out of range or "
                             f"still live")
    return streams, walls


def _vlm_run(torch, label, cfg, ctx, params, batch, record):
    """One weight mode of path 12: the logit check, then a counted graphed
    run (counts reset just before the prefill, read after the last
    block), the same graph serving a second prefill (no new capture),
    an eager run (identical streams and counts), and the timings."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import vlm
    from repro_torch.models.api import init_cache_fn
    from repro_torch.nn.attention import gqa_project_kv
    from repro_torch.nn.blocks import layer_slice
    from repro_torch.train.graphs import DecodeBlocks, _addresses
    v = VLM
    b, plen, gen, blk = v["batch"], v["plen"], v["gen"], v["block"]
    checks = vlm_logit_check(torch, cfg, params, ctx, batch,
                             steps=v["logit_steps"],
                             faults=ctx.mode == "int8")
    want = _vlm_expected(cfg, ctx.mode, ctx.use_lut, gen)
    cache = init_cache_fn(cfg, b, plen + gen, torch.float32, "cuda")
    addrs = _addresses(cache)
    graphed = DecodeBlocks(cfg, ctx, b, "cuda", graphs=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    streams, _ = _vlm_serve(torch, cfg, ctx, params, batch, graphed, cache)
    counts = launch_counts()
    got = {k: n for k, n in counts.items() if n}
    if got != want:
        raise AssertionError(f"vlm {label}: launches {got}, expected {want} "
                             f"(one prefill and {gen} decode steps)")
    record(counts)
    # the captured graph serves a second prefill into the same cache
    again, walls = _vlm_serve(torch, cfg, ctx, params, batch, graphed,
                              cache)
    if graphed.captures != 1 or _addresses(cache) != addrs \
            or not (again == streams).all():
        raise AssertionError(f"vlm {label}: {graphed.captures} captures, "
                             f"cache moved {_addresses(cache) != addrs}, "
                             f"streams equal {(again == streams).all()}")
    reset_launch_counts()
    eager, _ = _vlm_serve(torch, cfg, ctx, params, batch,
                          DecodeBlocks(cfg, ctx, b, "cuda", graphs=False),
                          cache)
    ecounts = {k: n for k, n in launch_counts().items() if n}
    if not (eager == streams).all() or ecounts != want:
        raise AssertionError(f"vlm {label}: eager streams equal "
                             f"{(eager == streams).all()}, launches "
                             f"{ecounts} (graphed {got})")
    # timings: the prefill and its image projection (CUDA events, warm),
    # decode wall per step (the second graphed run), device busy per step
    n_groups, _ = vlm._group_structure(cfg)
    dims = cfg.attn_dims(causal=False)
    img = batch["img_embed"].to(ctx.compute_dtype)
    prefill_ms = event_ms(torch, lambda: vlm.prefill(params, batch, cache,
                                                     cfg, ctx), reps=3)
    image_ms = event_ms(torch, lambda: [gqa_project_kv(
        layer_slice(params["cross"], g)["attn"], img, dims, ctx)
        for g in range(n_groups)], reps=3)
    state = graphed.pack(streams[:, :1], [plen] * b, [True] * b,
                         [plen + gen] * b, [0.0] * b, [0] * b, 0, -1)
    top = []
    busy, kernels = _profiled_busy(torch, lambda: graphed(
        params, cache, state, None, blk), top=top)
    cross_bytes = sum(t.numel() * t.element_size()
                      for t in cache["cross_kv"].values())
    run = dict(weights=label, launches=counts, logit_checks=checks,
               prefill_ms=prefill_ms, image_projection_ms=image_ms,
               prompt_ms=prefill_ms - image_ms,
               decode_wall_ms_per_step=statistics.median(walls[1:]) * 1e3
               / blk,
               device_busy_ms_per_step=None if busy is None else busy / blk,
               device_kernels_per_step=kernels / blk,
               cross_kv_bytes=cross_bytes,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2**30, captures=graphed.captures,
               top_per_step=[dict(kernel=k, ms=ms / blk, count=n / blk)
                             for k, ms, n in top])
    log(f"[vlm] {label}: prefill {prefill_ms:.2f} ms (image K/V "
        f"projection {image_ms:.2f} ms, the {plen}-token prompt "
        f"{run['prompt_ms']:.2f} ms; CUDA events), decode wall "
        f"{run['decode_wall_ms_per_step']:.3f} ms per step (graphed), device "
        f"busy {fmt_ms(run['device_busy_ms_per_step'])} per step, "
        f"{run['device_kernels_per_step']:.1f} device kernels and copies per "
        f"step, cross K/V {cross_bytes / 1e6:.1f} MB, peak memory "
        f"{run['max_memory_allocated_gib']:.2f} GiB allocated; launches "
        f"{json.dumps(got)}; graphed == eager, one capture")
    for k, ms, n in top[:8]:
        log(f"[vlm]   {ms / blk:8.3f} ms x{n / blk:<6.1f} a step  {k[:90]}")
    graphed.release()
    del cache
    return run


def _vlm_forward(torch, cfg, params, ctx, record):
    """(c): the cache-free ``vlm.forward`` with the image at B 4, S 512
    through the kernels and through the plain versions: flash once per
    self layer, qmatmul 7 times per layer (the image's K/V at 4 x 1601
    rows), logits gated as path 1's."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import vlm
    b, s = VLM["forward_b"], VLM["forward_s"]
    nb = make_batch(cfg, 1, b, s, seed=0)
    tokens = torch.from_numpy(nb["tokens"]).cuda()
    img = torch.from_numpy(nb["img_embed"]).cuda()
    del nb
    n_groups, k_self = vlm._group_structure(cfg)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, _ = vlm.forward(params, tokens, img, cfg, ctx)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    q = 7 * cfg.n_layers
    want = {"flash_attention": n_groups * k_self, "qmatmul": q,
            "quantize_rows": q}
    got = {k: n for k, n in counts.items() if n}
    if got != want:
        raise AssertionError(f"vlm cache-free forward: launches {got}, "
                             f"expected {want}")
    record(counts)
    ms = event_ms(torch, lambda: vlm.forward(params, tokens, img, cfg, ctx),
                  reps=3)
    lp, _ = vlm.forward(params, tokens, img, cfg,
                        dataclasses.replace(ctx, backend="ref"))
    check = gate_logits(torch, "[vlm]", f"vlm {ctx.mode} cache-free forward "
                        f"B {b} S {s} with the image", lk.float(), lp.float(),
                        ctx.compute_dtype)
    check.update(ms=ms, first_call_ms=first_ms, launches=counts)
    log(f"[vlm] cache-free forward B {b} S {s} with the image: {ms:.1f} ms "
        f"(CUDA events, warm; first call {first_ms:.1f} ms host clock), "
        f"launches {json.dumps(got)}")
    del lk, lp
    return check


def serve_vlm(torch, report) -> dict:
    """Path 12: llama-3.2-vision-11b (8 groups of 4 self layers and a
    gated cross layer; d_model 4096, 32 heads on 8 KV heads of 128, d_ff
    14336, vocab 128256, 1601 image tokens) at its published widths and
    full depth, through the serving step builders (the Engine refuses
    the vlm family: the reference Engine never passes the image), random
    weights from a seeded generator on the card with the gates drawn
    nonzero, bf16 compute, the dense f32 KV cache, batch 8, a 64-token
    prompt and the stub image from ``make_batch`` (8 x 1601 x 4096), 32
    greedy tokens in graphed blocks of 8:

    (a) int8 weights (PTQ of the f32 init, the f32 tree freed after);
    (c) with (a)'s weights, the cache-free forward at B 4, S 512 with the
    image; (b) bf16 weights under --lut.

    Per run: the logit check with its planted faults, the exact launch
    counts of one prefill and the decode blocks, graphed == eager, one
    capture serving two prefills; prefill ms (the image projection and
    the prompt apart), decode wall, device busy and kernels per step,
    cross K/V bytes and peak memory logged.  Returns the launch counts
    summed over the counted runs."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.serve import prepare_params, quantize_for_serving
    from repro_torch.models import vlm
    from repro_torch.nn.context import QuantContext

    cfg = get_config("llama-3.2-vision-11b")
    v = VLM
    nb = make_batch(cfg, 0, v["batch"], v["plen"], seed=0)
    batch = {"tokens": torch.from_numpy(nb["tokens"]).cuda(),
             "img_embed": torch.from_numpy(nb["img_embed"]).cuda()}
    del nb
    n_groups, k_self = vlm._group_structure(cfg)
    log(f"[vlm] llama-3.2-vision-11b full width and depth: {n_groups} groups "
        f"of {k_self} self layers + 1 gated cross layer, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.n_img_tokens} image tokens; batch {v['batch']}, prompt "
        f"{v['plen']}, {v['gen']} greedy tokens in graphed blocks of "
        f"{v['block']}")
    total, runs = {}, {}

    def record(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = QuantContext(mode="int8", compute_dtype=torch.bfloat16,
                       policy=PrecisionPolicy.uniform(FixedPointType(8, 4)))
    f32 = vlm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                   device="cuda")
    _vlm_gates(torch, f32, 1)
    params = prepare_params(quantize_for_serving(f32, ctx), ctx, "cuda")
    del f32
    gc.collect()
    torch.cuda.synchronize()
    log(f"[vlm] (a) f32 init and int8 PTQ in {time.perf_counter() - t0:.1f} "
        f"s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    runs["a int8"] = _vlm_run(torch, "(a) int8 weights", cfg, ctx, params,
                              batch, record)
    runs["c forward"] = _vlm_forward(torch, cfg, params, ctx, record)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ctx = QuantContext(mode="none", compute_dtype=torch.bfloat16,
                       use_lut=True)
    params = vlm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      dtype=torch.bfloat16, device="cuda")
    _vlm_gates(torch, params, 1)
    params = prepare_params(params, ctx, "cuda")
    runs["b lut"] = _vlm_run(torch, "(b) bf16 weights --lut", cfg, ctx,
                             params, batch, record)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    report["vlm"] = runs
    log(f"[vlm] launches over the counted runs: {json.dumps(total)}")
    return total


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


#: path 13 (a): gemma-2b trained at published width and full depth
TRAIN = dict(arch="gemma-2b", batch=8, seq=256, steps=6, peak=1e-4,
             warmup=1, total=8, seed=0)
#: path 13 (a)'s gradient gate: each leaf's relative L2 between step 0
#: through the kernels and the same step through the plain versions
#: (``backend="ref"``), in f32 and in bf16 compute; the planted faults must
#: read above it on at least one leaf.  The path also reads a second sound
#: version against the same oracle (the kernels' plain online softmax under
#: autograd): at full width and depth both read ~7.5e-5 in f32 and
#: 0.15-0.18 in bf16, where the random-init model's gradients are that
#: sensitive to the last bit of an attention output (PERF.md section 6)
TRAIN_GRAD_TOL = {"f32": 1e-3, "bf16": 0.3}
#: path 13 (b): the training CLI at smoke width (a full-width checkpoint is ~30
#: GB of disk); (c): the jet example's readings against the CPU's
TRAIN_CLI_ARGS = ["--arch", "gemma-2b", "--smoke", "--batch", "8", "--seq",
               "64", "--log-every", "0", "--device", "cuda"]
JET_TRAIN_TOL = 0.01


def _planted_bwd(torch, fk, kind):
    """Planted faults of the flash backward: ``dk`` zeroed, or ``dv`` moved
    one key row along the sequence (gemma has one KV head, so "the wrong
    KV head" is the wrong key)."""
    real = fk.flash_attention_bwd

    def bad(*a, **kw):
        dq, dk, dv = real(*a, **kw)
        if kind == "zeroed dk":
            return dq, torch.zeros_like(dk), dv
        return dq, dk, torch.roll(dv, 1, dims=2)
    return real, bad


def train_path(torch, report, profile: bool) -> dict:
    """Path 13: the paper's training on the card.

    (a) gemma-2b at published width and full depth through ``init_state``
    and ``build_train_step`` (what ``launch.train.main`` calls): f32
    params and AdamW state, bf16 compute, ``cfg.remat`` "full", batch 8 x
    256 tokens, cosine warmup (peak 1e-4, warmup 1, total 8), 6 steps,
    the first untimed.  Step 0's gradients through the kernels are held
    leaf by leaf against the same step through the plain versions
    (``backend="ref"``, on the card) within TRAIN_GRAD_TOL, which two
    planted faults of the flash backward must fail; losses finite and
    step 0's batch scoring lower after the steps than at step 0 (the same
    batch: the steps' batches differ); wall and busy a step, tokens/s, the
    share
    of bf16 peak, device time by kernel (the backward's share), flash
    launches a step, peak memory.  (b) ``launch.train.main`` on gemma-2b
    smoke: 8 steps with a checkpoint every 2 and a fault at step 5 ends
    bitwise where the unfailed run does, with one restore; a ``--quant
    fake --qbits 8`` run's loss is finite and drops.  (c) the jet
    example's ``main`` on the card and on the CPU: the f32 test accuracy
    and the seven formats' within JET_TRAIN_TOL.
    """
    import gc
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.registry import get_impl, register_op
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.data.pipeline import make_batch
    from repro_torch.examples import train_jet_mlp
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels._cuda import launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import flash_attention_plain
    from repro_torch.launch import train as train_cli
    from repro_torch.models.api import loss_fn
    from repro_torch.nn.context import QuantContext
    from repro_torch.optim import cosine_warmup
    from repro_torch.train.step import build_train_step, init_state

    out = {}
    counts_all = {}

    def add(counts):
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v

    # -- (a) gemma-2b at full width and depth -------------------------------
    t = TRAIN
    cfg = get_config(t["arch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(torch.Generator(device="cuda").manual_seed(t["seed"]),
                       cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    log(f"[train] (a) {t['arch']}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters, remat "
        f"{cfg.remat}; state (params, m, v) "
        f"{3 * 4 * n_params / 1e9:.2f} GB f32, init {time.perf_counter() - t0:.1f}s")

    def lr_fn(s):
        return cosine_warmup(s, peak=t["peak"], warmup=t["warmup"],
                             total=t["total"])

    ctx = QuantContext(compute_dtype=torch.bfloat16)
    step_fn = build_train_step(cfg, ctx, lr_fn=lr_fn)
    batches = [make_batch(cfg, i, t["batch"], t["seq"], seed=t["seed"])
               for i in range(t["steps"])]
    tokens = t["batch"] * t["seq"]

    # gradient gate at step 0, in f32 and in bf16 compute: the plain
    # versions' gradients to the host, then the kernels' and two planted
    # faults' against them, leaf by leaf
    gate = {}
    for cname, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cctx = QuantContext(compute_dtype=cd)
        kern = build_train_step(cfg, cctx, lr_fn=lr_fn)
        ref = build_train_step(cfg, dataclasses.replace(cctx, backend="ref"),
                               lr_fn=lr_fn)
        g_ref, _ = ref.compute_grads(state["params"], batches[0])
        host_ref = [(n, g.float().cpu())
                    for n, g in tree_paths(g_ref, "/").items()]
        ref_finite = all(bool(torch.isfinite(h).all()) for _, h in host_ref)
        del g_ref
        gc.collect()

        def readings(grads):
            rel = {}
            for (name, g), (_, h) in zip(tree_paths(grads, "/").items(),
                                          host_ref):
                r = h.to("cuda")
                rel[name] = float((g.float() - r).norm()
                                  / r.norm().clamp_min(1e-30))
                del r
            return rel

        reset_launch_counts()
        grads, _ = kern.compute_grads(state["params"], batches[0])
        torch.cuda.synchronize()
        grad_counts = launch_counts()
        rel = readings(grads)
        del grads
        # the noise floor: a second sound version (the plain online softmax
        # under autograd) in the oracle's place, against the oracle
        oracle = get_impl("attention", "ref")
        register_op("attention", "ref")(flash_attention_plain)
        try:
            gp, _ = ref.compute_grads(state["params"], batches[0])
        finally:
            register_op("attention", "ref")(oracle)
        floor = readings(gp)
        del gp
        worst = max(rel, key=rel.get)
        fw = max(floor, key=floor.get)
        tol = TRAIN_GRAD_TOL[cname]
        log(f"[train] (a) gradient gate, {cname} compute, step 0, kernels vs "
            f"plain versions (backend='ref') on the card: worst leaf {worst} "
            f"relative L2 {rel[worst]:.3g} (<= {tol}); a second sound "
            f"version (the plain online softmax) vs the same: {fw} "
            f"{floor[fw]:.3g}; launches of one gradient: flash forward "
            f"{grad_counts['flash_attention']}, backward "
            f"{grad_counts['flash_attention_bwd']}")
        if not rel[worst] <= tol:
            raise AssertionError(f"path 13 (a): {cname} gradient leaf {worst}"
                                 f" relative L2 {rel[worst]} beyond {tol}")
        faults = {}
        for kind in ("zeroed dk", "dv one key off"):
            real, bad = _planted_bwd(torch, fk, kind)
            fk.flash_attention_bwd = bad
            try:
                gf, _ = kern.compute_grads(state["params"], batches[0])
            finally:
                fk.flash_attention_bwd = real
            rf = readings(gf)
            del gf
            w = max(rf, key=rf.get)
            faults[kind] = (w, rf[w])
            log(f"[train] (a) planted fault ({kind}), {cname}: worst leaf {w}"
                f" relative L2 {rf[w]:.3g}")
            if rf[w] <= tol:
                raise AssertionError(f"path 13 (a): planted fault ({kind}) "
                                     f"passed the {cname} gradient gate "
                                     f"({rf[w]})")
        gate[cname] = dict(worst=(worst, rel[worst]), rel=rel, planted=faults,
                           floor=(fw, floor[fw]), launches=grad_counts)
        del host_ref, kern, ref
        gc.collect()

    # 6 steps: step 0 untimed, 1-3 on the host clock, 4-5 under the profiler
    reset_launch_counts()
    losses, walls, busy, top = [], [], None, []
    for i in range(t["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < 4:
            state, m = step_fn(state, batches[i])
            torch.cuda.synchronize()
        else:
            from torch.profiler import ProfilerActivity, profile as tprof
            with tprof(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                state, m = step_fn(state, batches[i])
                torch.cuda.synchronize()
            if i == t["steps"] - 1:
                rows = device_rows(prof)
                busy = sum(r[1] for r in rows) or None
                top = rows
        wall = time.perf_counter() - t0
        losses.append(float(m["loss"]))
        if i > 0:
            walls.append(wall)
        log(f"[train] (a) step {i}: loss {losses[-1]:.4f} grad_norm "
            f"{float(m['grad_norm']):.4f} lr {float(m['lr']):.3g} wall "
            f"{wall * 1e3:.1f} ms")
    counts = launch_counts()
    add(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the trained model's loss on step 0's batch, against step 0's loss
    with torch.no_grad():
        after = float(loss_fn(state["params"], {
            k: torch.as_tensor(v, device="cuda")
            for k, v in batches[0].items()}, cfg, ctx)[0])
    log(f"[train] (a) loss on step 0's batch: {losses[0]:.4f} before the "
        f"steps, {after:.4f} after {t['steps']}")
    if not all(map(math.isfinite, losses + [after])):
        raise AssertionError(f"path 13 (a): non-finite loss {losses}")
    if not after < losses[0]:
        raise AssertionError(f"path 13 (a): loss did not drop: {losses[0]} "
                             f"-> {after} on step 0's batch")
    for k in ("flash_attention", "flash_attention_bwd"):
        if counts.get(k, 0) == 0:
            raise AssertionError(f"path 13 (a): {k} never launched")
    wall = statistics.median(walls[:3])
    share = 6.0 * n_params * tokens / wall / BF16_FLOP_PER_S
    bwd_ms = sum(r[1] for r in top if "flash_bwd" in r[0])
    # the forward's kernels: the TMA one (flash_fwd_wgmma_kernel) and the
    # mma.sync and f32 ones (flash_attention_*_kernel)
    fwd_ms = sum(r[1] for r in top if "flash_fwd_" in r[0]
                 or "flash_attention_" in r[0])
    log(f"[train] (a) wall a step {wall * 1e3:.1f} ms (median of steps "
        f"1-3), busy {fmt_ms(busy)} (step {t['steps'] - 1}, profiled), "
        f"{tokens / wall:.0f} tokens/s, {100 * share:.2f}% of bf16 peak "
        f"(6 x {n_params / 1e9:.3f} B x {tokens} tokens), peak memory "
        f"{peak:.2f} GiB; flash forward {counts['flash_attention'] // t['steps']}"
        f" and backward {counts['flash_attention_bwd'] // t['steps']} launches "
        f"a step; the flash backward {bwd_ms:.1f} ms of the busy "
        f"({100 * bwd_ms / busy if busy else 0:.1f}%), forward "
        f"{fwd_ms:.1f} ms")
    for name, ms, n in top[:12 if profile else 6]:
        log(f"[train]   {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    out["a"] = dict(n_params=n_params, losses=losses,
                    loss_batch0_after=after, walls_s=walls,
                    wall_ms=wall * 1e3, busy_ms=busy,
                    tokens_per_s=tokens / wall, bf16_peak_share=share,
                    peak_gib=peak, launches=counts, gradient_gate=gate,
                    flash_bwd_ms=bwd_ms,
                    flash_fwd_ms=fwd_ms,
                    top=[(n, ms, c) for n, ms, c in top[:20]])
    del state, step_fn, m
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the training CLI: fault, restore, bitwise replay; QAT ---------
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        def drive(name, *extra):
            return train_cli.main(TRAIN_CLI_ARGS + ["--ckpt-dir",
                                                 os.path.join(tmp, name),
                                                 *extra])
        clean = drive("clean", "--steps", "8", "--ckpt-every", "2")
        failed = drive("failed", "--steps", "8", "--ckpt-every", "2",
                       "--fail-at", "5")
        same = all(same_raw_bits(torch, a, b) for a, b in zip(
            tree_leaves(clean["state"]["params"]),
            tree_leaves(failed["state"]["params"])))
        log(f"[train] (b) train CLI, 8 steps, checkpoint every 2, fault at 5: "
            f"restores {failed['restores']}, final params bitwise the "
            f"unfailed run's: {same}")
        if failed["restores"] != 1 or not same:
            raise AssertionError("path 13 (b): the restored run is not the "
                                 "unfailed run bit for bit")
        qat = ["--quant", "fake", "--qbits", "8", "--lr", "3e-3",
               "--ckpt-every", "100"]
        first = drive("qat0", "--steps", "1", *qat)
        last = drive("qat", "--steps", "20", *qat)
        l0 = float(first["metrics"]["loss"])
        l1 = float(last["metrics"]["loss"])
        log(f"[train] (b) --quant fake --qbits 8: loss {l0:.4f} at step 0, "
            f"{l1:.4f} after 20 steps")
        if not (math.isfinite(l1) and l1 < l0):
            raise AssertionError(f"path 13 (b): QAT loss {l0} -> {l1}")
    counts = launch_counts()
    add(counts)
    out["b"] = dict(restores=failed["restores"], bitwise=same,
                    qat_loss=(l0, l1), launches=counts)
    del clean, failed, first, last
    gc.collect()

    # -- (c) the paper's jet flow, card and CPU -----------------------------
    gpu = train_jet_mlp.main(["--device", "cuda"])
    cpu = train_jet_mlp.main(["--device", "cpu"])
    diffs = {"fp32": abs(gpu["acc_fp32"] - cpu["acc_fp32"])}
    diffs.update({k: abs(gpu["formats"][k] - cpu["formats"][k])
                  for k in cpu["formats"]})
    log(f"[train] (c) jet flow: f32 test accuracy card {gpu['acc_fp32']:.4f}"
        f" / CPU {cpu['acc_fp32']:.4f}; formats card {gpu['formats']} / CPU "
        f"{cpu['formats']}; largest difference {max(diffs.values()):.4f}")
    if max(diffs.values()) > JET_TRAIN_TOL:
        raise AssertionError(f"path 13 (c): the card's jet flow differs from "
                             f"the CPU's by more than {JET_TRAIN_TOL}: {diffs}")
    out["c"] = dict(card=gpu, cpu=cpu, diffs=diffs)
    report["train"] = out
    return counts_all


#: path 13 (d): gemma-2b at published width and full depth trained under
#: --quant int8 --lut (the launch CLI's policy, FixedPointType(8, 4)),
#: bf16 compute, 3 steps; (d2) one gradient of gemma-2b under --lut with
#: float weights; (d3) one of mamba2-370m under --lut at full width and
#: depth (its ungated tables: softplus on dt, silu on the conv and the
#: gate, lut_activation; a whole 256-token SSD chunk, whose masked decays
#: overflow f32 -- see ``nn/ssm.ssd_scan``)
TRAIN_QUANT = dict(arch="gemma-2b", batch=8, seq=256, steps=3, peak=1e-4,
                   warmup=1, total=8, seed=0, table_arch="mamba2-370m")
#: (d)'s gradient gate: step 0's gradients through the kernels against the
#: same gradients through the plain versions (``backend="ref"``), leaf by
#: leaf in relative L2, in f32 compute at TRAIN_GRAD_TOL["f32"] (which the
#: two planted faults must fail); both sides must be finite.  Both sides
#: run the flash kernels for the
#: attention (path 13 (a) holds those against their plain versions), so
#: the two forwards are bit for bit the same -- the int8 products, the
#: quantizer and the tables are bitwise their plain versions -- and the
#: reading is the backward kernels' alone (an int8 code that flipped on
#: an attention output's last bit would otherwise move a gradient far
#: more than any kernel's error)


def _planted_qmm_bwd(torch, qk, real, kind):
    """Planted faults of qmatmul's backward: the epilogue's table read one
    entry off (its slope, and the gated form's value, taken from the
    next entry: the wrapper's table, and the plain version's, which a
    CPU rehearsal runs), or the b_scale gradient zeroed."""
    from repro_torch.kernels import ref
    def bad(a, b, sa, sb, bias, dout, act_spec=None, act_gated=False):
        if kind == "zeroed b_scale gradient":
            dsa, dsb, dbias = real(a, b, sa, sb, bias, dout,
                                   act_spec=act_spec, act_gated=act_gated)
            return dsa, torch.zeros_like(dsb), dbias
        table = None if act_spec is None else qk.get_table(act_spec)

        class Shifted:
            def values(self, dev):
                return table.values(dev).roll(-1)
        orig = qk.get_table, ref.get_table
        qk.get_table = ref.get_table = lambda spec: Shifted()
        try:
            return real(a, b, sa, sb, bias, dout, act_spec=act_spec,
                        act_gated=act_gated)
        finally:
            qk.get_table, ref.get_table = orig
    return bad


def train_quant_path(torch, report, profile: bool) -> dict:
    """Path 13 (d): the paper's training under --quant int8 --lut.

    (d1) gemma-2b at published width and full depth, ``init_state`` and
    ``build_train_step`` under the launch CLI's --quant int8 --lut context
    (weights quantized per column and activations per row at each call,
    the gated GELU table in the gate projection's qmatmul epilogue), bf16
    compute, remat "full", batch 8 x 256 tokens: step 0's gradients held
    against the plain versions' (see TRAIN_QUANT) in f32 compute, the
    planted faults (the table slope one entry off; qmatmul's b_scale
    gradient zeroed) failing the f32 gate; then 3 steps (finite losses):
    wall (step 1), busy (step 2, profiled), tokens/s, peak memory,
    launches a step -- one qmatmul_bwd and one quantize_rows_bwd per int8
    projection (7 a layer).  (d2) gemma-2b under --lut with float
    weights: one f32 gradient, gated alike, lut_gated_mul_bwd once a
    layer.  (d3) mamba2-370m under --lut at full width and depth: one f32
    gradient, gated alike, lut_activation_bwd three times a layer (dt's
    softplus, the conv's and the gate's silu: the table alone)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.core.registry import get_impl, register_op
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.kernels._cuda import launch_counts, reset_launch_counts
    from repro_torch.nn.context import QuantContext
    from repro_torch.optim import cosine_warmup
    from repro_torch.train.step import build_train_step, init_state

    t = TRAIN_QUANT
    out = {}
    counts_all = {}

    def add(counts):
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v

    def ctx_of(mode, cd, backend=None):
        policy = (PrecisionPolicy.uniform(FixedPointType(8, 4))
                  if mode == "int8" else PrecisionPolicy())
        return QuantContext(mode=mode, policy=policy, use_lut=True,
                            compute_dtype=cd, backend=backend)

    def lr_fn(s):
        return cosine_warmup(s, peak=t["peak"], warmup=t["warmup"],
                             total=t["total"])

    def gate(label, cfg, params, batch, mode, faults=()):
        tol = TRAIN_GRAD_TOL["f32"]
        f32 = torch.float32
        kern = build_train_step(cfg, ctx_of(mode, f32), lr_fn=lr_fn)
        ref = build_train_step(cfg, ctx_of(mode, f32, "ref"), lr_fn=lr_fn)
        oracle = get_impl("attention", "ref")
        register_op("attention", "ref")(get_impl("attention", "cuda"))
        try:
            g_ref, _ = ref.compute_grads(params, batch)
        finally:
            register_op("attention", "ref")(oracle)
        host_ref = [(n, g.float().cpu())
                    for n, g in tree_paths(g_ref, "/").items()]
        ref_finite = all(bool(torch.isfinite(h).all()) for _, h in host_ref)
        del g_ref
        gc.collect()

        def readings(grads):
            rel = {}
            for (name, g), (_, h) in zip(tree_paths(grads, "/").items(),
                                          host_ref):
                r = h.to("cuda")
                rel[name] = float((g.float() - r).norm()
                                  / r.norm().clamp_min(1e-30))
                del r
            return rel

        reset_launch_counts()
        grads, metrics = kern.compute_grads(params, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        add(counts)
        finite = all(bool(torch.isfinite(g).all()) for g in
                     tree_leaves(grads))
        rel = readings(grads)
        del grads
        worst = max(rel, key=rel.get)
        log(f"[train] ({label}) gradient gate, f32 compute, step 0, "
            f"kernels vs plain versions (backend='ref', the attention on "
            f"the flash kernels on both sides): worst leaf {worst} "
            f"relative L2 {rel[worst]:.3g} (<= {tol}); loss "
            f"{float(metrics['loss']):.4f}; launches of one gradient: "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not (finite and ref_finite and rel[worst] <= tol):
            raise AssertionError(f"path 13 ({label}): f32 gradient leaf "
                                 f"{worst} relative L2 {rel[worst]} beyond "
                                 f"{tol} (finite: kernels {finite}, plain "
                                 f"versions {ref_finite})")
        planted = {}
        for kind in faults:
            real = get_impl("qmatmul_bwd", "cuda")
            register_op("qmatmul_bwd", "cuda")(
                _planted_qmm_bwd(torch, qk, real, kind))
            try:
                gf, _ = kern.compute_grads(params, batch)
            finally:
                register_op("qmatmul_bwd", "cuda")(real)
            rf = readings(gf)
            del gf
            w = max(rf, key=rf.get)
            planted[kind] = (w, rf[w])
            log(f"[train] ({label}) planted fault ({kind}), f32: worst "
                f"leaf {w} relative L2 {rf[w]:.3g}")
            if rf[w] <= tol:
                raise AssertionError(f"path 13 ({label}): planted fault "
                                     f"({kind}) passed the f32 gradient "
                                     f"gate ({rf[w]})")
        del host_ref, kern, ref
        gc.collect()
        return dict(worst=(worst, rel[worst]), tol=tol, launches=counts,
                    planted=planted)

    # -- (d1) gemma-2b under --quant int8 --lut -----------------------------
    cfg = get_config(t["arch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(torch.Generator(device="cuda").manual_seed(t["seed"]),
                       cfg, device="cuda")
    batches = [make_batch(cfg, i, t["batch"], t["seq"], seed=t["seed"])
               for i in range(t["steps"])]
    tokens = t["batch"] * t["seq"]
    log(f"[train] (d1) {t['arch']} at full width and depth ({cfg.n_layers} "
        f"layers) under --quant int8 --lut (FixedPointType(8, 4)), bf16 "
        f"compute, remat {cfg.remat}, {t['batch']} x {t['seq']} tokens")
    gates = {"f32": gate("d1", cfg, state["params"], batches[0], "int8",
                         faults=("table slope one entry off",
                                 "zeroed b_scale gradient"))}
    per_layer = 7 * cfg.n_layers
    g_counts = gates["f32"]["launches"]
    for k in ("qmatmul_bwd", "quantize_rows_bwd"):
        if g_counts.get(k, 0) != per_layer:
            raise AssertionError(f"path 13 (d1): {k} launched "
                                 f"{g_counts.get(k, 0)} times in a gradient,"
                                 f" not once per int8 projection "
                                 f"({per_layer})")
    step_fn = build_train_step(cfg, ctx_of("int8", torch.bfloat16),
                               lr_fn=lr_fn)
    reset_launch_counts()
    losses, walls, busy, top = [], [], None, []
    for i in range(t["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < t["steps"] - 1:
            state, m = step_fn(state, batches[i])
            torch.cuda.synchronize()
        else:
            from torch.profiler import ProfilerActivity, profile as tprof
            with tprof(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                state, m = step_fn(state, batches[i])
                torch.cuda.synchronize()
            top = device_rows(prof)
            busy = sum(r[1] for r in top) or None
        wall = time.perf_counter() - t0
        walls.append(wall)
        losses.append(float(m["loss"]))
        log(f"[train] (d1) step {i}: loss {losses[-1]:.4f} grad_norm "
            f"{float(m['grad_norm']):.4f} lr {float(m['lr']):.3g} wall "
            f"{wall * 1e3:.1f} ms")
    counts = launch_counts()
    add(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"path 13 (d1): non-finite loss {losses}")
    step_counts = {k: v / t["steps"] for k, v in counts.items() if v}
    for k in ("qmatmul_bwd", "quantize_rows_bwd"):
        if step_counts.get(k, 0) != per_layer:
            raise AssertionError(f"path 13 (d1): {k} {step_counts.get(k)} "
                                 f"launches a step, not {per_layer}")
    wall = walls[1]
    bwd = {k: sum(r[1] for r in top if f in r[0]) for k, f in (
        ("qmatmul_bwd", "qmm_bwd_"), ("quantize_rows_bwd",
                                      "quantize_rows_bwd"))}
    log(f"[train] (d1) wall a step {wall * 1e3:.1f} ms (step 1), busy "
        f"{fmt_ms(busy)} (step 2, profiled), {tokens / wall:.0f} tokens/s, "
        f"peak memory {peak:.2f} GiB; launches a step {step_counts}; device "
        f"ms a step: qmatmul_bwd {bwd['qmatmul_bwd']:.2f}, quantize_rows_bwd "
        f"{bwd['quantize_rows_bwd']:.2f}")
    for name, ms, n in top[:12 if profile else 8]:
        log(f"[train]   {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    out["d1"] = dict(layers=cfg.n_layers, gates=gates, losses=losses,
                     walls_s=walls, wall_ms=wall * 1e3, busy_ms=busy,
                     tokens_per_s=tokens / wall, peak_gib=peak,
                     launches_per_step=step_counts, bwd_device_ms=bwd,
                     top=[(n, ms, c) for n, ms, c in top[:20]])
    del step_fn, m

    # -- (d2) gemma-2b under --lut, float weights ---------------------------
    out["d2"] = gate("d2", cfg, state["params"], batches[0], "none")
    if out["d2"]["launches"].get("lut_gated_mul_bwd", 0) != cfg.n_layers:
        raise AssertionError(f"path 13 (d2): lut_gated_mul_bwd launched "
                             f"{out['d2']['launches'].get('lut_gated_mul_bwd')}"
                             f" times, not once a layer ({cfg.n_layers})")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d3) mamba2-370m under --lut --------------------------------------
    mcfg = get_config(t["table_arch"])
    mstate = init_state(torch.Generator(device="cuda").manual_seed(t["seed"]),
                        mcfg, device="cuda")
    mbatch = make_batch(mcfg, 0, t["batch"], t["seq"], seed=t["seed"])
    log(f"[train] (d3) {t['table_arch']} at full width and depth "
        f"({mcfg.n_layers} layers) under --lut, f32 compute, "
        f"{t['batch']} x {t['seq']} tokens (SSD chunk {mcfg.ssm.chunk})")
    out["d3"] = gate("d3", mcfg, mstate["params"], mbatch, "none")
    tables = 3 * mcfg.n_layers
    if out["d3"]["launches"].get("lut_activation_bwd", 0) != tables:
        raise AssertionError(f"path 13 (d3): lut_activation_bwd launched "
                             f"{out['d3']['launches'].get('lut_activation_bwd')}"
                             f" times, not three times a layer ({tables})")
    del mstate
    gc.collect()
    torch.cuda.empty_cache()
    report["train_quant"] = out
    return counts_all


#: path 14: path 13 (a)'s settings through the DTensor path on a
#: one-rank NCCL mesh, 3 steps at microbatches 2 with grad_specs; (e) the
#: elastic save and restore at smoke width
DIST_TRAIN = dict(arch="gemma-2b", batch=8, seq=256, steps=3, micro=2,
                  peak=1e-4, warmup=1, total=8, seed=0)
#: path 14's planted fault: the second microbatch's loss scaled by this,
#: a gradient change that path 13's bf16 gate cannot see
DIST_FAULT_SCALE = 1.01


def _host_leaves(torch, tree):
    from repro_torch.core.tree import tree_paths
    from repro_torch.dist.sharding import is_dtensor
    return {n: (g.to_local() if is_dtensor(g) else g).float().cpu()
            for n, g in tree_paths(tree, "/").items()}


def dist_train_path(torch, report, profile: bool) -> dict:
    """Path 14: the sharded trainer (``repro_torch.dist``) on the card.

    A one-rank NCCL process group (a ``FileStore`` under a temp dir) and
    ``make_local_mesh(model=1)``; gemma-2b at published width and full
    depth with path 13 (a)'s settings (f32 state, bf16 compute, remat
    "full", batch 8 x 256, the same seed and schedule), 3 steps at
    microbatches 2 with ``grad_specs`` on, once without a mesh (the
    unsharded step) and once with the state placed as DTensors.  Gates:
    the sharded step-0 gradients leaf by leaf and the 3 losses bitwise
    the unsharded ones (on one rank the mesh changes no arithmetic; path
    13 (a)'s bf16 gate, which two different attentions need, is printed
    beside it); a planted fault, the second microbatch's loss scaled by
    ``DIST_FAULT_SCALE``, must fail that gate; the flash forward and
    backward kernels launched by the sharded steps; NCCL and the card, no gloo, no CPU; (e) at smoke width
    a checkpoint saved from the mesh at step 2 restores (with the mesh's
    shardings) and replays steps 2-3 bitwise.  Readings: wall and busy a
    step and peak memory, beside path 13's.
    """
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import make_batch
    from repro_torch.dist import (PerfFlags, flags, named, param_specs,
                                  set_flags, use_mesh)
    from repro_torch.dist.sharding import is_dtensor
    from repro_torch.kernels._cuda import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.nn.context import QuantContext
    from repro_torch.optim import cosine_warmup
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import build_train_step, init_state

    t = DIST_TRAIN
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    old_flags = flags()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    set_flags(PerfFlags(grad_specs=True))
    try:
        mesh = make_local_mesh(model=1)
        backend = dist.get_backend()
        log(f"[dist] one-rank process group, backend {backend}; mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on "
            f"{mesh.device_type}")
        if backend != "nccl" or mesh.device_type != "cuda":
            raise AssertionError(f"path 14: backend {backend} on "
                                 f"{mesh.device_type}, not NCCL on the card")
        cfg = get_config(t["arch"])
        ctx = QuantContext(compute_dtype=torch.bfloat16)

        def lr_fn(s):
            return cosine_warmup(s, peak=t["peak"], warmup=t["warmup"],
                                 total=t["total"])

        batches = [make_batch(cfg, i, t["batch"], t["seq"], seed=t["seed"])
                   for i in range(t["steps"])]
        tokens = t["batch"] * t["seq"]

        # -- the unsharded step: step-0 gradients to the host, 3 losses --
        state = init_state(torch.Generator(device="cuda").manual_seed(
            t["seed"]), cfg, device="cuda")
        plain = build_train_step(cfg, ctx, lr_fn=lr_fn,
                                 microbatches=t["micro"])
        g, _ = plain.compute_grads(state["params"], batches[0])
        host = _host_leaves(torch, g)
        del g
        plain_losses = []
        for b in batches:
            state, m = plain(state, b)
            plain_losses.append(float(m["loss"]))
        del state, plain, m
        gc.collect()
        torch.cuda.empty_cache()

        # -- the sharded step on the mesh --------------------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with use_mesh(mesh):
            state = init_state(torch.Generator(device="cuda").manual_seed(
                t["seed"]), cfg, device="cuda")
            leaves = tree_leaves(state)
            if not all(is_dtensor(x) and x.to_local().is_cuda
                       for x in leaves):
                raise AssertionError("path 14: a state leaf is not a DTensor "
                                     "on the card")
            step = build_train_step(
                cfg, ctx, lr_fn=lr_fn, microbatches=t["micro"],
                grad_specs=param_specs(state["params"], mesh))
            tol = TRAIN_GRAD_TOL["bf16"]

            def against_unsharded(g):
                rel, same = {}, 0
                for name, x in _host_leaves(torch, g).items():
                    h = host[name]
                    rel[name] = float((x - h).norm()
                                      / h.norm().clamp_min(1e-30))
                    same += bool(torch.equal(x, h))
                return rel, same, max(rel, key=rel.get)

            # the planted fault first, so the launch counts are the
            # sound gradient's and steps'
            real_loss = step_mod.loss_fn
            calls = []

            def scaled_loss(*a, **kw):
                loss, metrics = real_loss(*a, **kw)
                calls.append(1)
                return (loss * DIST_FAULT_SCALE if len(calls) == 2
                        else loss), metrics
            step_mod.loss_fn = scaled_loss
            try:
                g, _ = step.compute_grads(state["params"], batches[0])
            finally:
                step_mod.loss_fn = real_loss
            rel, same, worst = against_unsharded(g)
            del g
            fault = (same, (worst, rel[worst]))
            log(f"[dist] planted fault (microbatch 2's loss x "
                f"{DIST_FAULT_SCALE}): {same} of {len(rel)} leaves bitwise, "
                f"worst leaf {worst} relative L2 {rel[worst]:.3g} (the bf16 "
                f"gate {tol} would {'pass' if rel[worst] <= tol else 'fail'} "
                f"it)")
            if same == len(rel):
                raise AssertionError("path 14: the planted fault passes the "
                                     "bitwise gradient gate")
            reset_launch_counts()
            g, _ = step.compute_grads(state["params"], batches[0])
            rel, same, worst = against_unsharded(g)
            del g, host
            log(f"[dist] step-0 gradients, sharded vs unsharded (bf16, "
                f"microbatches {t['micro']}): {same} of {len(rel)} leaves "
                f"bitwise (gate: all); worst leaf {worst} relative L2 "
                f"{rel[worst]:.3g} (path 13's bf16 gate: {tol})")
            if same != len(rel):
                raise AssertionError(f"path 14: {len(rel) - same} gradient "
                                     f"leaves differ from the unsharded "
                                     f"step's; worst {worst} relative L2 "
                                     f"{rel[worst]}")
            losses, walls, busy, top = [], [], None, []
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i < t["steps"] - 1:
                    state, m = step(state, b)
                    torch.cuda.synchronize()
                else:
                    from torch.profiler import ProfilerActivity
                    from torch.profiler import profile as tprof
                    with tprof(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                        state, m = step(state, b)
                        torch.cuda.synchronize()
                    top = device_rows(prof)
                    busy = sum(r[1] for r in top) or None
                wall = time.perf_counter() - t0
                losses.append(float(m["loss"]))
                if i > 0:
                    walls.append(wall)
                log(f"[dist] step {i}: loss {losses[-1]:.6f} (unsharded "
                    f"{plain_losses[i]:.6f}) grad_norm "
                    f"{float(m['grad_norm']):.4f} wall {wall * 1e3:.1f} ms")
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
        dl = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
        log(f"[dist] losses sharded vs unsharded: bitwise "
            f"{losses == plain_losses} (gate); largest relative difference "
            f"{max(dl):.3g}")
        if not all(math.isfinite(x) for x in losses) or losses != plain_losses:
            raise AssertionError(f"path 14: losses {losses} vs unsharded "
                                 f"{plain_losses}")
        for k in ("flash_attention", "flash_attention_bwd"):
            if counts.get(k, 0) == 0:
                raise AssertionError(f"path 14: {k} never launched")
        p13 = report.get("train", {}).get("a", {})
        log(f"[dist] on {report.get('nvidia_smi', 'an unnamed card')}: "
            f"wall a step {walls[0] * 1e3:.1f} ms (step 1; step 2 "
            f"profiled {walls[-1] * 1e3:.1f}), busy {fmt_ms(busy)}, "
            f"{tokens / walls[0]:.0f} tokens/s, peak memory {peak:.2f} GiB; "
            f"path 13 (a) in this run: wall {p13.get('wall_ms', 0):.1f} ms, "
            f"busy {fmt_ms(p13.get('busy_ms'))}, peak "
            f"{p13.get('peak_gib', 0):.2f} GiB; flash forward "
            f"{counts.get('flash_attention', 0)} and backward "
            f"{counts.get('flash_attention_bwd', 0)} launches in "
            f"{t['steps']} steps and one gradient")
        for name, ms, n in top[:12 if profile else 6]:
            log(f"[dist]   {ms:9.3f} ms  x{n:<5d} {name[:90]}")
        out["a"] = dict(losses=losses, plain_losses=plain_losses,
                        loss_rel=dl, grad_worst=(worst, rel[worst]),
                        fault_bitwise_leaves=fault[0],
                        fault_worst=fault[1],
                        grad_bitwise_leaves=same, leaves=len(rel),
                        walls_s=walls, busy_ms=busy, peak_gib=peak,
                        launches=counts, backend=backend,
                        path13=dict(wall_ms=p13.get("wall_ms"),
                                    busy_ms=p13.get("busy_ms"),
                                    peak_gib=p13.get("peak_gib")),
                        top=[(n, ms, c) for n, ms, c in top[:20]])
        del state, step, m, leaves
        gc.collect()
        torch.cuda.empty_cache()

        # -- (e) elastic checkpoint at smoke width -----------------------
        scfg = cfg.smoke()
        sb = [make_batch(scfg, i, 4, 32) for i in range(4)]
        with use_mesh(mesh), tempfile.TemporaryDirectory() as ck:
            st = init_state(torch.Generator(device="cuda").manual_seed(1),
                            scfg, device="cuda")
            sh = named(param_specs(st, mesh), mesh)
            sstep = build_train_step(scfg, ctx, lr_fn=lr_fn, microbatches=2,
                                     grad_specs=param_specs(st["params"],
                                                            mesh))
            manager = CheckpointManager(ck)
            for i in range(2):
                st, _ = sstep(st, sb[i])
            manager.save(st, 2)
            for i in (2, 3):
                st, _ = sstep(st, sb[i])
            back, at = manager.restore_latest(st, shardings=sh)
            for i in (2, 3):
                back, _ = sstep(back, sb[i])
            replay = all(
                same_raw_bits(torch, a.to_local(), b.to_local())
                if a.is_floating_point() else torch.equal(a.to_local(),
                                                          b.to_local())
                for a, b in zip(tree_leaves(st), tree_leaves(back)))
        log(f"[dist] (e) smoke checkpoint from the mesh at step {at}, "
            f"restored with its shardings, steps 2-3 replayed: bitwise "
            f"{replay}")
        if at != 2 or not replay:
            raise AssertionError("path 14 (e): the restored run is not the "
                                 "saved run bit for bit")
        out["e"] = dict(step=at, bitwise=replay)
    finally:
        set_flags(old_flags)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    report["dist"] = out
    return counts


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
                *, steps: int, name: str = ""):
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
    t, split = _resolve_knobs(width, ps, max(1, cfg.n_kv_heads), batch, None,
                              None)
    ctxs = {name: dataclasses.replace(ctx, kv_split=split, pages_per_step=t,
                                      backend=backend)
            for name, backend in (("kernels", None), ("plain", "ref"))}
    pp = prepare_params(params, ctxs["kernels"], "cuda")
    mode = f"{name}{ctx.mode}{' +lut' if ctx.use_lut else ''}"
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
#: tensor-core flash kernels (TMA and wgmma <DP, consumer warpgroups>;
#: mma.sync <DP>), the Hopper paged kernel (<float4 columns a lane>) and
#: the control paged kernel (both routes, one instance per head-dim
#: class), qmatmul (the TMA instances <kind, boxes, rows>:
#: kind 0 the weight stream, 1 wgmma; the parent kernel <16, MB> decode,
#: <128, 1> otherwise), the table kernel (<dtype, gated>), the quantizer's
#: register path (<dtype, threads a row>) and the flash backward's
#: kernels (tensor cores: dq and dk/dv blocks in one grid <DP, DC>; CUDA
#: cores: dk/dv and dq <DJ>)
PTXAS_KERNELS = ("flash_fwd_wgmma_kernel", "flash_attention_bf16_kernel",
                 "paged_hopper_kernel", "paged_attention_kernel",
                 "qmatmul_kernel", "qmm_tma_kernel", "lut_kernel",
                 "quantize_rows_vec_kernel",
                 "flash_bwd_bf16_kernel", "flash_bwd_dkdv_kernel",
                 "flash_bwd_dq_kernel")


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
            "flash_attention_bwd": "h gemma-train B=8 H=8/1 Sq=256 Skv=256 "
                                   "D=256 causal=True bf16",
            "lut_gated_mul": "gelu_gate interp 8x16384 bfloat16",
            "quantize_rows": "8x2048 bfloat16",
            "lut_gated_mul_bwd": f"gelu_gate interp {TRAIN_TOKENS}x16384 "
                                 f"bfloat16",
            "lut_activation_bwd": f"gelu_gate interp {TRAIN_TOKENS}x16384 "
                                  f"bfloat16",
            "quantize_rows_bwd": f"{TRAIN_TOKENS}x2048 bfloat16",
            "qmatmul_bwd": "up/gate +gelu epilogue"}
    source = {"qmatmul": "src/repro_torch/kernels/csrc/qmatmul.cu",
              "paged_attention_unsplit":
                  "src/repro_torch/kernels/csrc/paged_attention.cu",
              "paged_attention_split":
                  "src/repro_torch/kernels/csrc/paged_attention.cu",
              "lut_activation":
                  "src/repro_torch/kernels/csrc/lut_activation.cu",
              "flash_attention":
                  "src/repro_torch/kernels/csrc/flash_attention.cu",
              "flash_attention_bwd":
                  "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
              "lut_gated_mul":
                  "src/repro_torch/kernels/csrc/lut_activation.cu",
              "quantize_rows":
                  "src/repro_torch/kernels/csrc/quantize_rows.cu",
              "lut_gated_mul_bwd":
                  "src/repro_torch/kernels/csrc/lut_activation.cu",
              "lut_activation_bwd":
                  "src/repro_torch/kernels/csrc/lut_activation.cu",
              "quantize_rows_bwd":
                  "src/repro_torch/kernels/csrc/quantize_rows.cu",
              "qmatmul_bwd": "src/repro_torch/kernels/csrc/qmatmul_bwd.cu"}
    replaces = {"qmatmul": "src/repro/kernels/qmatmul.py:104",
                "paged_attention_unsplit":
                    "src/repro/kernels/flash_attention.py:217",
                "paged_attention_split":
                    "src/repro/kernels/flash_attention.py:514",
                "lut_activation": "src/repro/kernels/lut_activation.py:74",
                "flash_attention": "src/repro/kernels/flash_attention.py:101",
                # no Pallas kernel: XLA's autodiff of the einsum / chunked
                # attention that the reference trains through
                "flash_attention_bwd": "XLA autodiff of "
                                       "src/repro/nn/attention.py:441-449",
                # the TPU table kernel and the two products XLA applies
                # after it (activations.py:41, blocks.py:72)
                "lut_gated_mul": "src/repro/kernels/lut_activation.py:74",
                # no Pallas kernel: the XLA fusion before every int8 matmul
                "quantize_rows": "src/repro/nn/linear.py:88",
                # no Pallas kernel: XLA's autodiff of what the forward
                # kernels compute (training under --lut and --quant int8)
                "lut_gated_mul_bwd": "XLA autodiff of src/repro/kernels/"
                                     "lut_activation.py:36 (the table) and "
                                     "src/repro/nn/activations.py:41, "
                                     "nn/blocks.py:72",
                "lut_activation_bwd": "XLA autodiff of src/repro/kernels/"
                                      "lut_activation.py:36",
                "quantize_rows_bwd": "XLA autodiff of "
                                     "src/repro/core/quantize.py:85-87",
                "qmatmul_bwd": "XLA autodiff of src/repro/kernels/ref.py:32 "
                               "(the forward of qmatmul.py:104)"}
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
        if name == "flash_attention_bwd":
            out[-1]["library_note"] = ("SDPA's backward on K/V expanded to "
                                       "the query heads (its forward not "
                                       "timed)")
            out[-1]["kernels"] = ("one launch: delta; the dq and dk/dv "
                                  "blocks in one grid (bf16); the sum of "
                                  "dk/dv's split partials")
        if name == "quantize_rows":
            out[-1]["library_note"] = ("none (no PyTorch call quantizes); "
                                       "context: torch.amax(x.abs(), 1) on "
                                       "the same bytes")
            out[-1]["context_amax_abs_ms"] = rep["amax_abs_ms"]
        if name in ("lut_gated_mul_bwd", "lut_activation_bwd"):
            out[-1]["library_note"] = ("none (no PyTorch call is a table "
                                       "lookup's slope)")
        if name == "quantize_rows_bwd":
            out[-1]["library_note"] = ("autograd's backward of torch.amax("
                                       "x.abs(), 1) (no 1e-12 floor)")
        if name == "qmatmul_bwd":
            out[-1]["library_note"] = ("torch._int_mm, then the three "
                                       "reductions in f32 (no epilogue "
                                       "derivative)")
        if name.startswith("paged_attention"):
            out[-1]["kernel"] = ("paged_hopper_kernel" if rep["instance"]
                                 == "hopper" else "paged_attention_kernel")
            out[-1]["entry"] = ("paged_attention_hopper_launch"
                                if rep["instance"] == "hopper"
                                else "paged_attention_launch")
            out[-1]["plan"] = rep["plan"]
            out[-1]["control_kernel_ms"] = rep["control_ms"]
            out[-1]["control_launches"] = counts.get(
                "paged_attention_control", 0)
        if name == "qmatmul":
            out[-1]["library_note"] = ("none at M 8 (torch._int_mm needs M "
                                       "> 16); context: _int_mm on A padded "
                                       "to M 32, and amax reading B")
            out[-1]["context_int_mm_m32_ms"] = rep["int_mm_m32_ms"]
            out[-1]["context_read_weights_ms"] = rep["read_weights_ms"]
            out[-1]["plan"] = rep["plan"]
            out[-1]["parent_kernel_ms"] = rep["parent_ms"]
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
    t_checks = time.perf_counter()
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
    check_train_bwd(torch, timer, rows)
    torch.cuda.synchronize()
    check_flash(torch, timer, rows)
    torch.cuda.synchronize()
    check_flash_bwd(torch, timer, rows)
    torch.cuda.synchronize()
    check_sampling(torch, timer, report)
    torch.cuda.synchronize()
    check_verify(torch, timer, report)
    torch.cuda.synchronize()
    report["checks"] = rows
    report["checks_s"] = time.perf_counter() - t_checks
    log(f"[paths] phase 3 (kernel checks): {report['checks_s']:.1f}s")
    counts = {}
    if not args.kernels:
        # 4. the main path: gemma-2b's four paths, then whisper-base; the
        # flash forward's launches by kernel are counted over all paths
        from repro_torch.kernels.flash_attention import FLASH_FWD_ROUTES
        for route in FLASH_FWD_ROUTES:
            FLASH_FWD_ROUTES[route] = 0
        del timer
        seconds = report["path_seconds"] = {}
        for name, run in (
                ("1-4, 6, 8, 9 (gemma-2b serving)",
                 lambda: serve_main_path(torch, report, args.profile)),
                ("5 (whisper)",
                 lambda: serve_whisper(torch, report, args.profile)),
                ("7 (jet)", lambda: serve_jet(torch, report)),
                ("10 (family)", lambda: serve_family(torch, report)),
                ("11 (recurrent)", lambda: serve_recurrent(torch, report)),
                ("12 (vlm)", lambda: serve_vlm(torch, report)),
                ("13 a-c (train)",
                 lambda: train_path(torch, report, args.profile)),
                ("13 d (int8 / table training)",
                 lambda: train_quant_path(torch, report, args.profile)),
                ("14 (dist)",
                 lambda: dist_train_path(torch, report, args.profile))):
            t0 = time.perf_counter()
            mine = run()
            if not name.startswith("1-4"):
                no_control(f"path {name}", mine)
            for k, v in mine.items():
                counts[k] = counts.get(k, 0) + v
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            log(f"[paths] path {name}: {seconds[name]:.1f}s; paged attention "
                f"hopper {mine.get('paged_attention_split', 0)} split + "
                f"{mine.get('paged_attention_unsplit', 0)} unsplit, control "
                f"{mine.get('paged_attention_control', 0)}")
        # paged attention on the paths: the Hopper kernel, and the control
        # where paged_plan routes a prefill chunk to it (path 1's
        # kv_split=1 Engine: gemma-2b's unsplit prefill)
        log(f"[paths] paged attention launches: hopper "
            f"{counts.get('paged_attention_split', 0)} split + "
            f"{counts.get('paged_attention_unsplit', 0)} unsplit, control "
            f"{counts.get('paged_attention_control', 0)}")
        # every path's bf16 forward runs the TMA kernel (the mma.sync
        # kernel is for head dims and alignments that no path has)
        report["flash_fwd_routes"] = dict(FLASH_FWD_ROUTES)
        log(f"[paths] flash forward launches by kernel: {FLASH_FWD_ROUTES}")
        if FLASH_FWD_ROUTES["mma"] or not FLASH_FWD_ROUTES["wgmma"]:
            raise AssertionError(f"a path's bf16 flash forward ran the "
                                 f"mma.sync kernel: {FLASH_FWD_ROUTES}")

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
