"""Training entry point: config -> state -> data -> resilient loop (port of
``repro.launch.train``).

Usage (CPU-scale; without ``--device cpu`` it runs on the card)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --steps 8 --batch 4 --seq 32 --ckpt-dir /tmp/ck \\
        --device cpu [--quant fake --qbits 8] [--fail-at 5]

Under ``torchrun`` (a process group in the environment) the state is
sharded FSDP x TP over a ``(world / model, model)`` mesh, ``model`` being
``--model-parallel``, as the reference's driver does: the state placed
with ``param_specs``, each batch's rows over ``data``, the gradients
pinned with ``grad_specs``, checkpoints restored elastically onto the
mesh, logs and checkpoint files from rank 0.  NCCL on the card, gloo
with ``--device cpu``::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch gemma-2b --smoke --steps 4 --batch 4 --seq 32 \
        --model-parallel 2 --device cpu --ckpt-dir /tmp/ck

Without a process group and with ``--model-parallel 1`` it is the
single-device driver.  Refused by name: a ``--model-parallel`` that does
not divide the world size; under more than one rank, the families and
configs no test holds under a mesh yet (``encdec``, ``ssm``, ``hybrid``,
``vlm``, MLA; ``--quant int8`` and ``--lut``: ROADMAP.md item 18b).
``--quant fake`` runs QAT: every weight fake-quantized to
``FixedPointType(qbits, max(qbits // 2, 2))`` with the straight-through
gradient.  ``--quant int8`` trains through the int8 kernels (the
weights quantized per column each call, the activations per row; input
and weight get gradients only through their scales, as in the
reference), ``--lut`` through the paper's tables (their slope), and the
two combine::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --smoke --steps 8 --batch 4 --seq 32 --quant int8 --lut \
        --device cpu

The state is f32 with bf16 compute (``--f32``: f32 compute); checkpoints
go to ``--ckpt-dir`` every ``--ckpt-every`` steps on a thread, a run
resumes from the newest one, and ``--fail-at`` injects faults that the
loop recovers from by restoring and replaying.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import tempfile

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..core.device import resolve_device
from ..core.precision import PrecisionPolicy
from ..core.qtypes import FixedPointType
from ..data.pipeline import make_batch
from ..dist import named, param_specs, use_mesh
from ..ft import FaultInjector, ResilientLoop, StragglerMonitor
from ..nn.context import QuantContext
from ..optim import cosine_warmup
from ..train.step import build_train_step, init_state
from .mesh import init_distributed, make_local_mesh

__all__ = ["build_ctx", "main"]


def build_ctx(args) -> QuantContext:
    policy = PrecisionPolicy()
    if args.quant != "none":
        qt = FixedPointType(args.qbits, max(args.qbits // 2, 2))
        policy = PrecisionPolicy.uniform(qt)
    return QuantContext(mode=args.quant, policy=policy, use_lut=args.lut,
                        compute_dtype=(torch.float32 if args.f32
                                       else torch.bfloat16),
                        reuse_factor=args.reuse_factor)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--quant", default="none",
                    choices=["none", "fake", "int8"])
    ap.add_argument("--qbits", type=int, default=8)
    ap.add_argument("--lut", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--reuse-factor", type=int, default=1)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject faults at these steps (FT demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain kernel versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    sharded = init_distributed(device) or args.model_parallel > 1
    mesh = None
    if sharded:
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world % args.model_parallel:
            raise ValueError(f"--model-parallel {args.model_parallel} does "
                             f"not divide the world size {world}")
        if world > 1 and (cfg.family != "lm" or cfg.attn_kind == "mla"):
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}"
                f"{', MLA' if cfg.attn_kind == 'mla' else ''}) under a mesh "
                f"of {world} ranks: only the lm family's GQA configs are "
                f"held under a mesh; the rest is ROADMAP.md item 18b")
        if world > 1 and (args.quant == "int8" or args.lut):
            raise NotImplementedError(
                f"--quant {args.quant}{' --lut' if args.lut else ''} under a "
                f"mesh of {world} ranks: int8 and table training are held "
                f"on one device only; under a mesh they are ROADMAP.md "
                f"item 18b")
        mesh = make_local_mesh(args.model_parallel, device=device)
    rank0 = mesh is None or not any(mesh.get_coordinate())
    logging.basicConfig(level=logging.INFO if rank0 else logging.WARNING,
                        format="%(asctime)s %(name)s %(message)s")
    ctx = build_ctx(args)
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = init_state(gen, cfg, device=device)
        shardings = (None if mesh is None
                     else named(param_specs(state, mesh), mesh))
        step_fn = build_train_step(
            cfg, ctx,
            lr_fn=lambda s: cosine_warmup(s, peak=args.lr,
                                          warmup=max(args.steps // 20, 1),
                                          total=args.steps),
            microbatches=args.microbatches,
            grad_specs=(None if mesh is None
                        else param_specs(state["params"], mesh)))

        def batch_fn(step):
            b = make_batch(cfg, step, args.batch, args.seq, seed=args.seed)
            if mesh is not None:
                return b            # the step places each microbatch's rows
            return {k: torch.as_tensor(v, device=device)
                    for k, v in b.items()}

        manager = CheckpointManager(args.ckpt_dir, keep=3)
        restored, ckpt_step = manager.restore_latest(state,
                                                     shardings=shardings)
        start = 0
        if restored is not None:
            state, start = restored, ckpt_step
            if rank0:
                print(f"resumed from checkpoint step {start}")
        loop = ResilientLoop(
            step_fn, batch_fn, manager, checkpoint_every=args.ckpt_every,
            fault_injector=(FaultInjector(args.fail_at) if args.fail_at
                            else None),
            straggler=StragglerMonitor())
        out = loop.run(state, start_step=start, num_steps=args.steps,
                       shardings=shardings, log_every=args.log_every)
    if rank0:
        print(f"done: step={out['step']} "
              f"loss={float(out['metrics']['loss']):.4f} "
              f"restores={out['restores']}")
    return out


if __name__ == "__main__":
    main()
