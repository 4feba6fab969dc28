"""Shared helpers of the port's distribution suites
(``test_torch_dist_*``): a gloo world of CPU processes spawned once per
module, and the jobs its ranks run.

The world is ``torch.multiprocessing`` processes on ``127.0.0.1``; a job
writes numpy files into the module's directory, which the parent reads
and compares.  Two 2-rank meshes over ranks {0, 1} and {2, 3} run side by
side (two-rank ``DeviceMesh`` objects), then one mesh over all four
(``make_local_mesh``).
Test-only: the weight-gather spy hooks a private DTensor function.
"""

from __future__ import annotations

import contextlib
import os
import socket
import traceback

import numpy as np

#: the train jobs' geometry: 3 steps of batch 4 x seq 32, 2 microbatches
STEPS, BATCH, SEQ, MICRO = 3, 4, 32, 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one gloo
    group, started at once; :meth:`join` waits and raises if a rank
    failed."""

    def __init__(self, world: int, fn, *args):
        import torch.multiprocessing as mp
        self.ctx = mp.start_processes(
            _entry, args=(world, free_port(), fn, args), nprocs=world,
            join=False, start_method="spawn")

    def join(self, timeout: float = 300.0) -> None:
        import time
        t_end = time.time() + timeout
        while not self.ctx.join(timeout=max(1.0, t_end - time.time())):
            if time.time() > t_end:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError("the gloo world timed out")


def _entry(rank, world, port, fn, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def lr_t(s):
    from repro_torch.optim import cosine_warmup
    return cosine_warmup(s, peak=1e-3, warmup=1, total=4)


def full_numpy(tree, prefix=""):
    """``{path: numpy}`` of a tree of DTensors or tensors (a collective per
    DTensor leaf: every rank of the mesh calls it)."""
    from repro_torch.dist.sharding import is_dtensor
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(full_numpy(v, f"{prefix}/{k}"))
        return out
    t = tree.full_tensor() if is_dtensor(tree) else tree
    return {prefix: t.detach().numpy().copy()}


def load_state(path):
    """A numpy state file (``np.savez`` of ``{path: array}``) as the
    port's nested tree of CPU tensors."""
    import torch
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.strip("/").split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(z[key].copy())
    return out


def weight_shapes(params) -> set:
    """The global shapes a weight has where a product uses it: each leaf's
    and, for a stacked leaf, one layer's."""
    from repro_torch.core.tree import tree_leaves
    out = set()
    for p in tree_leaves(params):
        out.add(tuple(p.shape))
        if p.ndim >= 2:
            out.add(tuple(p.shape[1:]))
    return out


@contextlib.contextmanager
def implicit_gathers(shapes):
    """``{(shape, from, to): count}`` of the gathers DTensor's dispatch
    makes on its own (not asked for by ``redistribute``) of tensors with a
    weight's shape: a weight all-gathered where FSDP did not ask (torch's
    private hook, test-only)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor import _dispatch
    seen = {}
    real = _dispatch.redistribute_local_tensor

    def spy(local, cur, tgt, *a, **kw):
        gathered = any(isinstance(c, Shard) and not isinstance(t, Shard)
                       for c, t in zip(cur.placements, tgt.placements))
        if gathered and tuple(cur.shape) in shapes:
            key = (tuple(cur.shape), str(tuple(cur.placements)),
                   str(tuple(tgt.placements)))
            seen[key] = seen.get(key, 0) + 1
        return real(local, cur, tgt, *a, **kw)
    _dispatch.redistribute_local_tensor = spy
    try:
        yield seen
    finally:
        _dispatch.redistribute_local_tensor = real


def train_job(arch, mesh, flag_kw, grad_specs, outdir, tag, state_file,
              comm_counts=False):
    """3 sharded steps of ``arch`` smoke from ``state_file`` on ``mesh``;
    the first rank of the mesh writes the metrics and the final state to
    ``<outdir>/<tag>.npz``.
    ``comm_counts``: the last step's collectives as ``CommDebugMode``
    counts them, written too."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.dist import (PerfFlags, device_put, named, param_specs,
                                  set_flags, use_mesh)
    from repro_torch.nn.context import QuantContext
    from repro_torch.train.step import build_train_step

    cfg = get_config(arch).smoke()
    ctx = QuantContext(compute_dtype=torch.float32)
    set_flags(PerfFlags(**flag_kw))
    out = {}
    with use_mesh(mesh):
        state = load_state(state_file)
        state = device_put(state, named(param_specs(state, mesh), mesh))
        step = build_train_step(
            cfg, ctx, lr_fn=lr_t, microbatches=MICRO,
            grad_specs=(param_specs(state["params"], mesh) if grad_specs
                        else None))
        from torch.distributed.tensor.debug import CommDebugMode
        shapes = weight_shapes(state["params"])
        for i in range(STEPS):
            comm = CommDebugMode()
            last = comm_counts and i == STEPS - 1
            with comm if last else contextlib.nullcontext(), \
                    implicit_gathers(shapes) if last \
                    else contextlib.nullcontext() as gathers:
                state, m = step(state, make_batch(cfg, i, BATCH, SEQ))
            for k, v in m.items():
                out[f"metric/{i}/{k}"] = np.asarray(float(v), np.float64)
        if comm_counts:
            for op, n in comm.get_comm_counts().items():
                out[f"comm/{op}"] = np.asarray(n)
            out["weight_gathers"] = np.asarray(repr(sorted(gathers.items())))
        full = full_numpy(state)
    set_flags(PerfFlags())
    if not any(mesh.get_coordinate()):
        out.update({f"state{k}": v for k, v in full.items()})
        np.savez(os.path.join(outdir, f"{tag}.npz"), **out)


def ckpt_job(m21, m12, state_file, outdir):
    """Save a placed state on the (2, 1) mesh ``m21``, restore it on the
    (1, 2) mesh ``m12`` of the same ranks: the restored full tensors go
    to ``<outdir>/ckpt_12.npz``, the checkpoint to ``<outdir>/ckpt``, and
    each rank's count of the leaves it copied to the host during the save
    to ``<outdir>/ckpt_host_<rank>.npz``."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import store
    from repro_torch.dist import device_put, named, param_specs, use_mesh
    state = load_state(state_file)
    manager = CheckpointManager(os.path.join(outdir, "ckpt"), keep=2)
    copies = []
    real = store._to_numpy

    def spy(leaf):
        copies.append(1)
        return real(leaf)
    with use_mesh(m21):
        placed = device_put(state, named(param_specs(state, m21), m21))
        store._to_numpy = spy
        try:
            manager.save(placed, 7)          # on a thread; rank 0 writes
        finally:
            store._to_numpy = real
    np.savez(os.path.join(outdir, f"ckpt_host_{dist.get_rank()}.npz"),
             copies=np.asarray(len(copies)))
    with use_mesh(m12):
        sh = named(param_specs(state, m12), m12)
        restored, step = manager.restore_latest(state, shardings=sh)
        assert step == 7
        full = full_numpy(restored)
        wq = restored["params"]["dense"]["attn"]["wq"]["w"]
        assert [type(p).__name__ for p in wq.placements] == ["Shard",
                                                             "Shard"]
    if not any(m12.get_coordinate()):
        np.savez(os.path.join(outdir, "ckpt_12.npz"), **full)


def init_job(arch, mesh, outdir):
    """``init_state`` of ``arch`` smoke under ``mesh``, against the same
    init drawn without a mesh and placed: each rank writes to
    ``<outdir>/init_<rank>.npz`` the largest tensor (its local elements)
    that AdamW's init made there, the largest local shard and the largest
    whole parameter, whether every leaf is a DTensor of the placed init's
    placements and whether every local shard is bitwise the placed one."""
    import torch
    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode
    import repro_torch.train.step as step_mod
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist import device_put, named, param_specs, use_mesh
    from repro_torch.dist.sharding import is_dtensor

    made = []

    class Made(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    made.append((t.to_local() if is_dtensor(t) else t)
                                .numel())
            return out

    real = step_mod.adamw_init

    def spy(params, cfg):
        with Made():
            return real(params, cfg)
    cfg = get_config(arch).smoke()
    step_mod.adamw_init = spy
    try:
        with use_mesh(mesh):
            state = step_mod.init_state(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    finally:
        step_mod.adamw_init = real
    whole = step_mod.init_state(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    with use_mesh(mesh):
        want = device_put(whole, named(param_specs(whole, mesh), mesh))
    pairs = list(zip(tree_leaves(state), tree_leaves(want)))
    np.savez(
        os.path.join(outdir, f"init_{dist.get_rank()}.npz"),
        made=np.asarray(max(made)),
        shard=np.asarray(max(p.to_local().numel()
                             for p in tree_leaves(state["params"]))),
        full=np.asarray(max(p.numel() for p in tree_leaves(state["params"]))),
        placed=np.asarray(all(
            is_dtensor(a) and tuple(a.placements) == tuple(b.placements)
            for a, b in pairs)),
        bitwise=np.asarray(all(torch.equal(a.to_local(), b.to_local())
                               for a, b in pairs)))


def compression_job(pod, mesh, outdir):
    """``quantized_psum`` / ``quantized_psum_ef`` of each rank's
    ``RandomState(pod rank)`` inputs over the 1-D ``pod`` mesh, and
    ``make_pod_sharded_grad_fn`` on the (2, 1, 1) pod mesh ``mesh``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.core.qtypes import FixedPointType
    from repro_torch.dist.compression import (make_pod_sharded_grad_fn,
                                              quantized_psum,
                                              quantized_psum_ef)
    me = pod.get_local_rank("pod")
    qt = FixedPointType(8, 1)
    rs = np.random.RandomState(me)
    x = torch.from_numpy(rs.randn(8, 64).astype(np.float32))
    res = torch.from_numpy(rs.randn(8, 64).astype(np.float32) * 0.01)
    q = quantized_psum(x, "pod", qt, mesh=pod)
    exact = x.clone()
    dist.all_reduce(exact, group=pod.get_group("pod"))
    s_ef, r_ef = quantized_psum_ef(x, res, "pod", qt, mesh=pod)
    # the pod wrapper: grads of mean((batch @ p) ** 2) per pod, averaged
    inner = mesh["data", "model"]
    p0 = torch.from_numpy(np.random.RandomState(9).randn(64, 4)
                          .astype(np.float32))
    params = DTensor.from_local(p0.clone(), inner, [Replicate()] * 2)
    batch = DTensor.from_local(x, inner, [Replicate()] * 2)

    def grad_fn(p, b):
        p = p.detach().requires_grad_(True)
        loss = torch.mean((b @ p) ** 2)
        (g,) = torch.autograd.grad(loss, [p])
        return {"w": g}, {"loss": loss.detach()}

    out = {"q": q.numpy(), "exact": exact.numpy(), "sum_ef": s_ef.numpy(),
           "res_ef": r_ef.numpy(), "x": x.numpy(), "res": res.numpy()}
    for name, qtype in (("pod_q", qt), ("pod_f32", None)):
        g, m = make_pod_sharded_grad_fn(grad_fn, mesh, qtype=qtype)(
            params, batch)
        out[name] = g["w"].full_tensor().numpy()
        out[name + "_loss"] = np.asarray(float(m["loss"]))
    np.savez(os.path.join(outdir, f"compress_{me}.npz"), **out)


def cli_job(world, outdir):
    """The sharded CLI under a world of ``world`` ranks: its refusals,
    then gemma-2b smoke at ``--model-parallel 2`` for 2 steps with a fault
    at step 1 (restored from the step-1 checkpoint)."""
    from repro_torch.launch import train as train_cli
    base = ["--smoke", "--steps", "2", "--batch", str(BATCH), "--seq",
            str(SEQ), "--microbatches", str(MICRO), "--device", "cpu",
            "--f32", "--log-every", "0",
            "--ckpt-dir", os.path.join(outdir, "cli_ck")]
    refused = {}
    for arch, extra, err in (("whisper-base", [], NotImplementedError),
                             ("mamba2-370m", [], NotImplementedError),
                             ("zamba2-1.2b", [], NotImplementedError),
                             ("llama-3.2-vision-11b", [], NotImplementedError),
                             ("deepseek-v2-236b", [], NotImplementedError),
                             ("gemma-2b", ["--model-parallel", "3"],
                              ValueError),
                             ("gemma-2b", ["--quant", "int8"],
                              NotImplementedError),
                             ("gemma-2b", ["--lut"], NotImplementedError)):
        try:
            train_cli.main(["--arch", arch, *base, *extra])
        except err as e:
            refused[f"{arch}{''.join(extra)}"] = str(e)
    out = train_cli.main(["--arch", "gemma-2b", *base, "--model-parallel",
                          "2", "--ckpt-every", "1", "--fail-at", "1"])
    import torch.distributed as dist
    if dist.get_rank() == 0:
        np.savez(os.path.join(outdir, "cli.npz"),
                 refused=np.asarray(repr(refused)),
                 restores=np.asarray(out["restores"]),
                 step=np.asarray(out["step"]),
                 loss=np.asarray(float(out["metrics"]["loss"])))


#: the train jobs of the 4-rank world: (tag, arch, mesh shape, flags,
#: grad_specs, collective counts); the (2, 1) jobs run on ranks {0, 1},
#: the (1, 2) jobs on {2, 3} (each pair warms DTensor's caches for one
#: layout)
JOBS = [("g21on", "gemma-2b", (2, 1), {"grad_specs": True}, True, True),
        ("o21on", "olmoe-1b-7b", (2, 1), {"grad_specs": True}, True, True),
        ("o21einsum", "olmoe-1b-7b", (2, 1), {"moe_einsum": True}, False,
         False),
        ("g12on", "gemma-2b", (1, 2), {"grad_specs": True}, True, True),
        ("o12on", "olmoe-1b-7b", (1, 2), {"grad_specs": True}, True, True),
        ("o12local", "olmoe-1b-7b", (1, 2), {"moe_local": True}, False,
         False)]


def mark_ready(outdir) -> None:
    """Tell the world its inputs are written (the parent writes them while
    the ranks start)."""
    tmp = os.path.join(outdir, "ready.tmp")
    open(tmp, "w").close()
    os.replace(tmp, os.path.join(outdir, "ready"))


def wait_ready(outdir, timeout: float = 120.0) -> None:
    import time
    t_end = time.time() + timeout
    while not os.path.exists(os.path.join(outdir, "ready")):
        if time.time() > t_end:
            raise TimeoutError("the parent never wrote the world's inputs")
        time.sleep(0.05)


def _plain_tensor_refused(mesh) -> str:
    """What ``constrain`` says of a plain tensor under a 2-rank mesh."""
    import torch
    from repro_torch.dist import constrain, use_mesh
    with use_mesh(mesh):
        try:
            constrain(torch.zeros(4, 8), "dp", None)
        except TypeError as e:
            return str(e)
    return ""


def world(rank, world_size, outdir, states):
    """Everything the 4-rank world runs: the meshes first (every rank
    builds each, in the same order), then the (2, 1) jobs, the checkpoint
    and the compression on ranks {0, 1} while the (1, 2) jobs and the
    sharded init run on {2, 3}, then gemma at (2, 2) and the CLI on all
    four (the CLI at the same shapes, so it finds DTensor's caches
    warm)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import make_local_mesh
    meshes = {(lo, shape): DeviceMesh("cpu", torch.tensor([lo, lo + 1])
                                      .reshape(shape),
                                      mesh_dim_names=("data", "model"))
              for lo in (0, 2) for shape in ((2, 1), (1, 2))}
    pod = DeviceMesh("cpu", torch.tensor([0, 1]), mesh_dim_names=("pod",))
    pod3 = DeviceMesh("cpu", torch.tensor([0, 1]).reshape(2, 1, 1),
                      mesh_dim_names=("pod", "data", "model"))
    m22 = make_local_mesh(2, device="cpu")
    wait_ready(outdir)
    lo = 0 if rank < 2 else 2
    if rank == 0:
        np.savez(os.path.join(outdir, "escaped.npz"), refused=np.asarray(
            _plain_tensor_refused(meshes[0, (2, 1)])))
    elif rank == 1:
        _plain_tensor_refused(meshes[0, (2, 1)])
    for tag, arch, shape, fl, gs, cc in JOBS:
        if shape == ((2, 1) if lo == 0 else (1, 2)):
            train_job(arch, meshes[lo, shape], fl, gs, outdir, tag,
                      states[arch], comm_counts=cc)
    if lo == 0:
        ckpt_job(meshes[0, (2, 1)], meshes[0, (1, 2)], states["gemma-2b"],
                 outdir)
        compression_job(pod, pod3, outdir)
    else:
        init_job("gemma-2b", meshes[2, (1, 2)], outdir)
    dist.barrier()
    # grad_specs off (the flag unset); gemma's one K/V head does not
    # divide the model axis, so sp_attn replicates K/V
    train_job("gemma-2b", m22, {"sp_attn": True}, True, outdir, "g22",
              states["gemma-2b"])
    cli_job(world_size, outdir)
