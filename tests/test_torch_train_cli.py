"""The training CLI (``launch.train``) and its pieces: port vs ``repro``.

* Checkpoints: ``save_state`` writes the reference's layout (one ``.npy``
  per leaf named by its '.'-joined path, the same manifest keys), so
  each package restores the other's checkpoint bit for bit; atomic
  ``.tmp`` directories, a refused shape, retention, async save and
  ``restore_latest`` as the reference's ``tests/test_checkpoint.py``;
  bf16 leaves round-trip; a ``meta`` template restores to the CPU; an
  async save holds its step's values while the state is overwritten.
* ``ResilientLoop`` / ``FaultInjector`` mirror ``tests/test_ft.py``:
  recovery from injected faults, no checkpoint to restore, the restore
  limit on non-finite losses, and replay bitwise equal to an unfailed
  run (here exactly, with the port's train step on gemma smoke too).
* ``launch.train.main`` on gemma smoke with ``--fail-at``: one restore,
  final params bitwise the unfailed run's; ``--quant fake`` trains; the
  refused flags name their ROADMAP.md items; a second run resumes.
* ``batch_struct`` matches the reference's shapes and dtypes for every
  family; ``Prefetcher`` yields ``(step, batch)`` in order.
* The jet example's ``main`` at few steps: finite metrics and all seven
  formats; ``params_from_numpy`` takes the reference's bf16 moments bit
  for bit.
"""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_state as j_restore  # noqa: E402
from repro.checkpoint import save_state as j_save  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import batch_struct as j_batch_struct  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, latest_step, restore_state, save_state)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, batch_struct  # noqa: E402
from repro_torch.ft import FaultInjector, ResilientLoop  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from train_parity import flat  # noqa: E402


def make_state(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"w": torch.from_numpy(rng.randn(8, 16).astype(
                           np.float32)),
                       "stack": {"k": torch.from_numpy(rng.randn(3, 4, 4)
                                                       .astype(np.float32))}},
            "opt": {"m": torch.zeros((8, 16)),
                    "count": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(100, dtype=torch.int32)}


def _equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


# -- checkpoints ---------------------------------------------------------
def test_layout_matches_reference_both_ways(tmp_path):
    st = make_state()
    save_state(st, str(tmp_path / "port"), 100)
    jst = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), st)
    j_save(jst, str(tmp_path / "ref"), 100)
    names = sorted(os.listdir(tmp_path / "ref" / "step_00000100"))
    assert sorted(os.listdir(tmp_path / "port" / "step_00000100")) == names
    mp = json.load(open(tmp_path / "port" / "step_00000100" /
                        "manifest.json"))
    mr = json.load(open(tmp_path / "ref" / "step_00000100" /
                        "manifest.json"))
    assert mp["leaves"].keys() == mr["leaves"].keys()
    for k in mp["leaves"]:
        assert mp["leaves"][k]["shape"] == mr["leaves"][k]["shape"]
        assert mp["leaves"][k]["file"] == mr["leaves"][k]["file"]
    _equal(restore_state(st, str(tmp_path / "ref"), 100), st)
    back = j_restore(jst, str(tmp_path / "port"), 100)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_store_atomic_shapes_bf16_meta(tmp_path):
    st = make_state()
    st["opt"]["v"] = torch.randn(8, 16).to(torch.bfloat16)
    save_state(st, str(tmp_path), 1)
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert latest_step(str(tmp_path)) == 1
    _equal(restore_state(st, str(tmp_path), 1), st)
    with pytest.raises(ValueError):
        restore_state(dict(st, step=torch.zeros(2, dtype=torch.int32)),
                      str(tmp_path), 1)
    got = restore_state({"params": {"w": torch.empty((8, 16),
                                                     device="meta")}},
                        str(tmp_path), 1)
    assert got["params"]["w"].device.type == "cpu"
    assert torch.equal(got["params"]["w"], st["params"]["w"])


def test_manager_async_retention_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    st = make_state()
    assert m.restore_latest(st) == (None, None)
    m.save(st, 10)
    st2 = make_state(1)
    m.save(st2, 20)            # waits for step 10's thread first
    m.save(st2, 30, blocking=True)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000020", "step_00000030"]
    restored, step = m.restore_latest(st)
    assert step == 30
    _equal(restored, st2)


def test_async_save_holds_the_state_of_its_step(tmp_path, monkeypatch):
    """A non-blocking save keeps the values it was given although the
    caller overwrites the (CPU) state in place at once, as AdamW does:
    the worker is held until the overwrite is done."""
    from repro_torch.checkpoint import store
    go = threading.Event()
    write = store._write_state

    def held(*a, **kw):
        go.wait(10)
        return write(*a, **kw)

    monkeypatch.setattr(store, "_write_state", held)
    m = CheckpointManager(str(tmp_path))
    st = make_state()
    want = {k: v.clone() for k, v in flat(st).items()}
    m.save(st, 1)
    for leaf in flat(st).values():
        leaf.add_(1)
    go.set()
    m.wait()
    got = flat(restore_state(make_state(), str(tmp_path), 1))
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -- the resilient loop (tests/test_ft.py on the port) -------------------
def quad_step(state, batch):
    w = state["params"]
    g = 2 * (w - batch["target"])
    w2 = w - 0.1 * g
    loss = torch.sum((w2 - batch["target"]) ** 2)
    return {"params": w2, "step": state["step"] + 1}, {"loss": loss}


def batch_fn(step):
    return {"target": torch.tensor(float(step % 3))}


def _s0(v):
    return {"params": torch.tensor(v), "step": torch.tensor(0)}


def test_fault_recovery_resumes_from_checkpoint(tmp_path):
    loop = ResilientLoop(quad_step, batch_fn, CheckpointManager(str(tmp_path)),
                         checkpoint_every=5,
                         fault_injector=FaultInjector(fail_at=[12, 23]))
    out = loop.run(_s0(10.0), num_steps=30)
    assert out["restores"] == 2 and int(out["step"]) == 30
    assert np.isfinite(float(out["metrics"]["loss"]))


def test_no_checkpoint_to_restore_raises(tmp_path):
    loop = ResilientLoop(quad_step, batch_fn, CheckpointManager(str(tmp_path)),
                         checkpoint_every=100,
                         fault_injector=FaultInjector(fail_at=[0]))
    with pytest.raises(RuntimeError):
        loop.run(_s0(1.0), num_steps=5)


def test_max_restores_enforced(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def nan_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    loop = ResilientLoop(nan_step, batch_fn, mgr, checkpoint_every=1,
                         max_restores=3)
    mgr.save(_s0(1.0), 0, blocking=True)
    with pytest.raises(FloatingPointError):
        loop.run(_s0(1.0), num_steps=10)
    assert loop.restores == 4


def test_deterministic_replay(tmp_path):
    clean = ResilientLoop(quad_step, batch_fn,
                          CheckpointManager(str(tmp_path / "a")),
                          checkpoint_every=4)
    faulty = ResilientLoop(quad_step, batch_fn,
                           CheckpointManager(str(tmp_path / "b")),
                           checkpoint_every=4,
                           fault_injector=FaultInjector(fail_at=[9, 17]))
    a = clean.run(_s0(5.0), num_steps=20)
    b = faulty.run(_s0(5.0), num_steps=20)
    assert b["restores"] == 2
    assert torch.equal(a["state"]["params"], b["state"]["params"])


# -- the training CLI ----------------------------------------------------
TRAIN_CLI = ["--arch", "gemma-2b", "--smoke", "--batch", "4", "--seq", "16",
          "--log-every", "0", "--device", "cpu"]


def test_train_cli_fault_replay_bitwise_and_resume(tmp_path):
    clean = train_cli.main(TRAIN_CLI + ["--steps", "6", "--ckpt-every", "2",
                                     "--ckpt-dir", str(tmp_path / "a")])
    failed = train_cli.main(TRAIN_CLI + ["--steps", "6", "--ckpt-every", "2",
                                      "--fail-at", "3",
                                      "--ckpt-dir", str(tmp_path / "b")])
    assert clean["restores"] == 0 and failed["restores"] == 1
    assert clean["step"] == failed["step"] == 6
    _equal(clean["state"], failed["state"])
    # a second run over the same directory resumes at step 6
    again = train_cli.main(TRAIN_CLI + ["--steps", "2", "--ckpt-every", "2",
                                     "--ckpt-dir", str(tmp_path / "a")])
    assert again["step"] == 8 and int(again["state"]["step"]) == 8


def test_train_cli_fake_quant_and_refusals(tmp_path):
    out = train_cli.main(TRAIN_CLI + ["--steps", "3", "--quant", "fake",
                                   "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(float(out["metrics"]["loss"]))
    # --quant int8 --lut, once refused, trains
    out = train_cli.main(TRAIN_CLI + ["--steps", "2", "--quant", "int8",
                                   "--lut", "--ckpt-dir",
                                   str(tmp_path / "q")])
    assert out["step"] == 2 and np.isfinite(float(out["metrics"]["loss"]))
    # one process (no process group) is a world of 1 rank
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        train_cli.main(TRAIN_CLI + ["--steps", "1", "--ckpt-dir",
                                 str(tmp_path / "r"), "--model-parallel", "2"])


# -- data, example, conversion ------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma-2b", "whisper-base",
                                  "llama-3.2-vision-11b"])
def test_batch_struct_matches_reference(arch):
    from repro_torch.configs import get_config
    want = j_batch_struct(j_get_config(arch), 4, 32)
    got = batch_struct(get_config(arch), 4, 32)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
        assert got[k].device.type == "meta"


def test_prefetcher_in_order():
    pf = Prefetcher(lambda s: {"s": s * 2}, start_step=3, depth=2)
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert got == [(3, {"s": 6}), (4, {"s": 8}), (5, {"s": 10}),
                   (6, {"s": 12})]


def test_jet_example_main_few_steps():
    from repro_torch.examples import train_jet_mlp
    out = train_jet_mlp.main(["--steps", "30", "--device", "cpu"])
    assert 0.2 < out["acc_fp32"] <= 1.0
    assert len(out["formats"]) == 7
    assert all(0.0 <= a <= 1.0 for a in out["formats"].values())
    assert np.isfinite(out["lut_max_dp"]) and out["device"] == "cpu"


def test_train_state_converts_with_bf16_moments():
    from repro.optim import OptConfig, adamw_init
    p = {"w": jnp.asarray(np.random.RandomState(0).randn(4, 3), jnp.float32)}
    opt = adamw_init(p, OptConfig(m_dtype=jnp.bfloat16,
                                  v_dtype=jnp.bfloat16))
    opt["m"]["w"] = (p["w"] * 3).astype(jnp.bfloat16)
    st = {"params": p, "opt": opt, "step": jnp.asarray(5, jnp.int32)}
    from torch_parity import jax_to_numpy
    got = params_from_numpy(jax_to_numpy(st))
    assert got["opt"]["m"]["w"].dtype == torch.bfloat16
    assert np.array_equal(got["opt"]["m"]["w"].view(torch.int16).numpy(),
                          np.asarray(opt["m"]["w"]).view(np.int16))
    assert got["step"].shape == () and int(got["step"]) == 5
