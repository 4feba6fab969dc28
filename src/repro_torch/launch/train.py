"""Training entry point: config -> state -> data -> resilient loop (port of
``repro.launch.train``).

Usage (CPU-scale; without ``--device cpu`` it runs on the card)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --steps 8 --batch 4 --seq 32 --ckpt-dir /tmp/ck \\
        --device cpu [--quant fake --qbits 8] [--fail-at 5]

The reference's flags.  One device, no mesh: ``--model-parallel`` above 1
is refused (ROADMAP.md item 18), and so are ``--quant int8`` and
``--lut`` (their backward is item 16c).  ``--quant fake`` runs QAT: every
weight fake-quantized to ``FixedPointType(qbits, max(qbits // 2, 2))``
with the straight-through gradient.  The state is f32 with bf16 compute
(``--f32``: f32 compute); checkpoints go to ``--ckpt-dir`` every
``--ckpt-every`` steps on a thread, a run resumes from the newest one, and
``--fail-at`` injects faults that the loop recovers from by restoring and
replaying.
"""

from __future__ import annotations

import argparse
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
from ..ft import FaultInjector, ResilientLoop, StragglerMonitor
from ..nn.context import QuantContext
from ..optim import cosine_warmup
from ..train.step import build_train_step, init_state

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

    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs a device mesh, which the port does "
            "not have yet: ROADMAP.md item 18 (train on one device)")
    if args.quant == "int8" or args.lut:
        raise NotImplementedError(
            "training under --quant int8 or --lut is not ported: their "
            "backward (the table kernels' slope, the int8 scales) is "
            "ROADMAP.md item 16c; use --quant none or fake")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    ctx = build_ctx(args)
    step_fn = build_train_step(
        cfg, ctx,
        lr_fn=lambda s: cosine_warmup(s, peak=args.lr,
                                      warmup=max(args.steps // 20, 1),
                                      total=args.steps),
        microbatches=args.microbatches)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_state(gen, cfg, device=device)

    def batch_fn(step):
        b = make_batch(cfg, step, args.batch, args.seq, seed=args.seed)
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    manager = CheckpointManager(args.ckpt_dir, keep=3)
    restored, ckpt_step = manager.restore_latest(state)
    start = 0
    if restored is not None:
        state, start = restored, ckpt_step
        print(f"resumed from checkpoint step {start}")
    loop = ResilientLoop(
        step_fn, batch_fn, manager, checkpoint_every=args.ckpt_every,
        fault_injector=FaultInjector(args.fail_at) if args.fail_at else None,
        straggler=StragglerMonitor())
    out = loop.run(state, start_step=start, num_steps=args.steps,
                   log_every=args.log_every)
    print(f"done: step={out['step']} "
          f"loss={float(out['metrics']['loss']):.4f} "
          f"restores={out['restores']}")
    return out


if __name__ == "__main__":
    main()
