"""The sharded train step, checkpoints, compression and CLI on a gloo
world of four CPU ranks, against the port's unsharded step and the JAX
package's trainer.

One world is spawned for the module (``dist_parity.world``): ranks
{0, 1} run the (2, 1) mesh and {2, 3} the (1, 2) mesh side by side --
gemma-2b smoke and olmoe-1b-7b smoke, 3 steps at microbatches 2 with
``grad_specs`` on, and olmoe with it off under ``moe_einsum`` at (2, 1)
and ``moe_local`` at (1, 2) -- then gemma at (2, 2) with it off under
``sp_attn``, and the CLI, on all four.  While it runs, the parent
computes the same 3 steps unsharded with the port and with the
reference's jitted step, from the same init (the port's, drawn in the
parent).

* Loss, accuracy and grad_norm within rtol 1e-5 of the port's unsharded
  step and each state leaf (params and moments) within relative L2 1e-5;
  against the reference: loss rtol 1e-5, params relative L2 1e-4
  (``test_torch_train_step.py``'s tolerances).
* The collectives of the last step at (2, 1) and (1, 2)
  (``CommDebugMode``):
  at (2, 1) every all-gather is an FSDP weight gather, one per weight use
  (gemma smoke: 7 projections x 2 layers, the table twice, the 2 stacked
  norms = 18 a microbatch; olmoe smoke: 4 x 2 projections, 2 routers,
  the head, the table, 2 norms = 14) and each comes back as one
  reduce-scatter.  At (1, 2) the reference's layout (TP on every weight's
  d_out) gathers activations over ``model``; of the weights only the
  stacked norm scales are gathered there, which FSDP did not ask for
  (DTensor's dispatch, watched through torch's private hook).  A weight
  replicated by accident would still give the right numbers, so the
  counts are what shows it.
* ``init_state`` under a mesh is the unsharded init placed, bitwise,
  and AdamW's init there makes nothing larger than a rank's shard: the
  moments are never whole on a rank.
* A checkpoint saved at (2, 1) restores at (1, 2) and in one process,
  bitwise; only the writing rank copies the state to the host.
* ``quantized_psum`` is bitwise the sum of the reference's
  ``_round_trip`` of each rank's input and within its 5% of the exact
  sum; ``quantized_psum_ef``'s sum and residual are bitwise;
  ``make_pod_sharded_grad_fn`` on a (2, 1, 1) pod mesh averages the
  pods' (round-tripped) gradients.
* The CLI under 4 ranks: its refusals by name, and a run at
  ``--model-parallel 2`` with a fault restored from a checkpoint.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dist_parity as dp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import make_batch  # noqa: E402
from repro.optim import cosine_warmup as j_cosine  # noqa: E402
from repro.train.step import build_train_step as j_build  # noqa: E402
from torch_parity import contexts  # noqa: E402
from train_parity import flat, rel_l2  # noqa: E402

ARCHS = ("gemma-2b", "olmoe-1b-7b")
TRAIN_TAGS = [t[0] for t in dp.JOBS] + ["g22"]

#: collectives of one step (microbatches 2) of the grad_specs jobs, as
#: ``CommDebugMode`` counts them
COMM = {
    "g21on": {"all_gather_into_tensor": 36, "reduce_scatter_tensor": 36,
              "all_reduce": 11},
    "o21on": {"all_gather_into_tensor": 28, "reduce_scatter_tensor": 28,
              "all_reduce": 25},
    "g12on": {"all_gather_into_tensor": 140, "reduce_scatter_tensor": 56,
              "all_reduce": 9},
    "o12on": {"all_gather_into_tensor": 108, "reduce_scatter_tensor": 28,
              "all_reduce": 9},
}

#: the same steps' weight all-gathers that no ``redistribute`` asked for
#: (DTensor chose them): none at (2, 1); at (1, 2) the stacked norm
#: scales, whose d_model axis the (dp, tp) rule puts on ``model``, are
#: gathered where they scale a replicated row (4 a microbatch in gemma,
#: 2 in olmoe)
_NORM = ((128,), "(Replicate(), Shard(dim=0))", "(Replicate(), Replicate())")
WEIGHT_GATHERS = {"g21on": [], "o21on": [], "g12on": [(_NORM, 8)],
                  "o12on": [(_NORM, 4)]}


def _arch(tag):
    return "gemma-2b" if tag.startswith("g") else "olmoe-1b-7b"


def _lr_j(s):
    return j_cosine(s, peak=1e-3, warmup=1, total=4)


def _jax_tree(state_file):
    """A numpy state file as the reference's nested tree of arrays."""
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        dp.load_state(state_file))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the world, compute the unsharded references meanwhile, then
    read what the ranks wrote."""
    from repro_torch.configs import get_config
    from repro_torch.train.step import build_train_step, init_state
    out = str(tmp_path_factory.mktemp("dist"))
    states = {arch: os.path.join(out, f"{arch}.npz") for arch in ARCHS}
    world = dp.World(4, dp.world, out, states)    # starts while we init
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # the smoke steps, beside the four ranks
    try:
        for arch in ARCHS:
            st = init_state(torch.Generator().manual_seed(0),
                            get_config(arch).smoke(), device="cpu")
            np.savez(states[arch],
                     **{k: v.numpy() for k, v in flat(st).items()})
        dp.mark_ready(out)
        jctx, tctx = contexts("none")
        ref = {}
        for arch in ARCHS:
            cfg = j_get_config(arch).smoke()
            batches = [make_batch(cfg, i, dp.BATCH, dp.SEQ)
                       for i in range(dp.STEPS)]
            jstep = jax.jit(j_build(cfg, jctx, lr_fn=_lr_j,
                                    microbatches=dp.MICRO))
            tstep = build_train_step(cfg, tctx, lr_fn=dp.lr_t,
                                     microbatches=dp.MICRO)
            js, ts = _jax_tree(states[arch]), dp.load_state(states[arch])
            jm, tm = [], []
            for b in batches:
                js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
                jm.append({k: float(v) for k, v in m.items()})
                ts, m = tstep(ts, b)
                tm.append({k: float(v) for k, v in m.items()})
            ref[arch] = {"jax": ({k: np.asarray(v)
                                  for k, v in flat(js).items()}, jm),
                         "port": ({k: v.numpy()
                                   for k, v in flat(ts).items()}, tm)}
    finally:
        torch.set_num_threads(threads)
    world.join(timeout=240)

    def load(name):
        with np.load(os.path.join(out, name)) as z:
            return {k: z[k] for k in z.files}
    return {"dir": out, "ref": ref, "load": load, "states": states}


@pytest.mark.parametrize("tag", TRAIN_TAGS)
def test_sharded_steps_match(runs, tag):
    got = runs["load"](f"{tag}.npz")
    ref = runs["ref"][_arch(tag)]
    pstate, pm = ref["port"]
    jstate, jm = ref["jax"]
    for i in range(dp.STEPS):
        for key in ("loss", "accuracy", "grad_norm", "lr"):
            v = float(got[f"metric/{i}/{key}"])
            np.testing.assert_allclose(v, pm[i][key], rtol=1e-5,
                                       err_msg=f"{key} step {i}")
        np.testing.assert_allclose(float(got[f"metric/{i}/loss"]),
                                   jm[i]["loss"], rtol=1e-5)
    for k, want in pstate.items():
        have = got[f"state{k}"]
        assert have.shape == want.shape, k
        if k.startswith("/params") or k.startswith("/opt/m") \
                or k.startswith("/opt/v"):
            assert rel_l2(have, want) <= 1e-5, k
        else:
            np.testing.assert_array_equal(have, want, err_msg=k)
        if k.startswith("/params"):
            assert rel_l2(have, jstate[k]) <= 1e-4, k


@pytest.mark.parametrize("tag", sorted(COMM))
def test_collective_counts(runs, tag):
    got = runs["load"](f"{tag}.npz")
    counts = {k.split(".")[-1]: int(v) for k, v in got.items()
              if k.startswith("comm/")}
    assert counts == COMM[tag]
    assert ast.literal_eval(str(got["weight_gathers"])) == \
        WEIGHT_GATHERS[tag]


def test_init_state_places_moments_as_shards(runs):
    """``init_state`` at (1, 2): every leaf a DTensor of ``param_specs``'s
    placements, bitwise the unsharded init placed, and nothing AdamW's
    init made on a rank is larger than the rank's largest shard (the
    moments are made from the placed params, never whole)."""
    for rank in (2, 3):
        got = runs["load"](f"init_{rank}.npz")
        assert bool(got["placed"]) and bool(got["bitwise"]), rank
        assert int(got["shard"]) < int(got["full"]), rank
        assert int(got["made"]) <= int(got["shard"]), rank


def test_checkpoint_copies_to_host_on_the_writer_only(runs):
    """The save at (2, 1): the mesh's first rank copies every leaf to the
    host, the other rank none (it takes part in the gathers only)."""
    n = len(np.load(runs["states"]["gemma-2b"]).files)
    assert int(runs["load"]("ckpt_host_0.npz")["copies"]) == n
    assert int(runs["load"]("ckpt_host_1.npz")["copies"]) == 0


def test_elastic_checkpoint(runs):
    """Saved at (2, 1), restored at (1, 2) and in this process (no process
    group), bitwise the state that was saved."""
    from repro_torch.checkpoint import CheckpointManager
    want = dict(np.load(runs["states"]["gemma-2b"]))
    got = runs["load"]("ckpt_12.npz")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    template = dp.load_state(runs["states"]["gemma-2b"])
    restored, step = CheckpointManager(
        os.path.join(runs["dir"], "ckpt")).restore_latest(template)
    assert step == 7
    for k, v in flat(restored).items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_compression(runs):
    from repro.core.qtypes import FixedPointType as JFixed
    from repro.dist.compression import _round_trip
    qt = JFixed(8, 1)
    r = [runs["load"](f"compress_{i}.npz") for i in range(2)]

    def rt(a):
        return np.asarray(_round_trip(jnp.asarray(a), qt))

    want = rt(r[0]["x"]) + rt(r[1]["x"])
    for i in range(2):
        np.testing.assert_array_equal(r[i]["q"], want)
        exact = r[i]["exact"]
        assert np.abs(exact - r[i]["q"]).max() / np.abs(exact).max() < 0.05
        t = r[i]["x"] + r[i]["res"]
        np.testing.assert_array_equal(r[i]["res_ef"], t - rt(t))
        np.testing.assert_array_equal(
            r[i]["sum_ef"], rt(r[0]["x"] + r[0]["res"])
            + rt(r[1]["x"] + r[1]["res"]))
    # the pod wrapper: each pod's gradient of mean((x @ p) ** 2)
    p = torch.from_numpy(np.random.RandomState(9).randn(64, 4)
                         .astype(np.float32))
    grads, losses = [], []
    for i in range(2):
        w = p.clone().requires_grad_(True)
        loss = torch.mean((torch.from_numpy(r[i]["x"]) @ w) ** 2)
        grads.append(torch.autograd.grad(loss, [w])[0].numpy())
        losses.append(float(loss.detach()))
    for i in range(2):
        np.testing.assert_allclose(r[i]["pod_f32"], (grads[0] + grads[1])
                                   * 0.5, rtol=1e-6)
        np.testing.assert_allclose(r[i]["pod_q"], (rt(grads[0])
                                                   + rt(grads[1])) * 0.5,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(r[i]["pod_q_loss"]),
                                   np.mean(losses), rtol=1e-6)


def test_cli_under_four_ranks(runs):
    got = runs["load"]("cli.npz")
    refused = ast.literal_eval(str(got["refused"]))
    for arch in ("whisper-base", "mamba2-370m", "zamba2-1.2b",
                 "llama-3.2-vision-11b", "deepseek-v2-236b"):
        assert "18b" in refused[arch], arch
    assert "does not divide the world size 4" in \
        refused["gemma-2b--model-parallel3"]
    # int8 and table training run on one device since item 16c; under a
    # mesh they are item 18b
    assert "18b" in refused["gemma-2b--quantint8"]
    assert "18b" in refused["gemma-2b--lut"]
    assert int(got["restores"]) == 1 and int(got["step"]) == 2
    assert np.isfinite(float(got["loss"]))


def test_plain_tensor_under_a_mesh_is_refused(runs):
    """``constrain`` of a plain tensor under a mesh of 2 ranks raises: a
    tensor that escaped the sharding."""
    got = runs["load"]("escaped.npz")
    assert "escaped the sharding" in str(got["refused"])
