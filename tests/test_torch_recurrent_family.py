"""The recurrent families on the port, held against ``repro.models.
ssm_lm`` (mamba2-370m) and ``repro.models.hybrid`` (zamba2-1.2b) from the
same weights (the reference's init, converted through numpy), smoke size
(4 layers; the hybrid's shared block every 2), and the hybrid at 5 layers
(two groups and a tail layer).

* Per-unit outputs (every mamba layer and every application of the shared
  block, each fed the reference's input of that unit, on a throwaway copy
  of the cache) and logits: the cache-free forward, a whole-prompt
  prefill into the dense or paged cache, and decode steps.  f32 within a
  relative L2 error of 1e-5; int8 PTQ weights (or the hybrid's int8 KV
  cache) within 1e-3 per unit (a norm's last-bit difference can move one
  activation code), and the whole model's int8 logits and states within
  1e-2 (each unit's moved codes carry on through the later units); also
  under the LUT activations.
* The recurrent states after the prefill, and the port's cache tensors
  keep their addresses across prefill and decode (the state is written in
  place).
* Configs, smoke reductions and parameter counts equal the reference's;
  the step builders' whole-prompt prefill and the cache-free forward.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import ssm_lm as jssm_lm  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn.embedding import embed as j_embed  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models import ssm_lm as tssm_lm  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.train.graphs import _addresses  # noqa: E402

from torch_parity import contexts, int8_policies, smoke_params  # noqa: E402

F32_REL_L2 = 1e-5
INT8_REL_L2 = 1e-3
#: whole-model int8 quantities (logits, the states after a prefill): each
#: unit's moved codes (within the unit gate) carry on through later units
INT8_MODEL_REL_L2 = 1e-2
B, S, STEPS, MAX_LEN = 2, 16, 2, 24
PS, WIDTH, NUM_PAGES = 4, 7, 16
#: (arch, layers): the smoke configs and the hybrid with a tail
MODELS = [("mamba2-370m", None), ("zamba2-1.2b", None), ("zamba2-1.2b", 5)]
IDS = ["mamba2", "zamba2", "zamba2-tail"]

_PARAMS = {}


def _params(arch, layers, mode):
    if (arch, layers, mode) not in _PARAMS:
        _PARAMS[arch, layers, mode] = smoke_params(mode, arch=arch,
                                                   n_layers=layers)
    return _PARAMS[arch, layers, mode]


def _check(got, want, mode, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    tol = INT8_REL_L2 if mode == "int8" else F32_REL_L2
    assert err <= tol, f"{what}: relative L2 err {err}"


def _check_model(got, want, mode, what):
    if mode == "int8":
        err = float(np.linalg.norm(np.asarray(got, np.float64) - want)
                    / np.linalg.norm(np.asarray(want, np.float64)))
        assert err <= INT8_MODEL_REL_L2, f"{what}: relative L2 err {err}"
    else:
        _check(got, want, mode, what)


def _fams(cfg):
    return ((jssm_lm, tssm_lm) if cfg.family == "ssm"
            else (jhybrid, thybrid))


def _tree_at(tree, *idx):
    return jax.tree_util.tree_map(lambda t: t[idx], tree)


def _units(cfg):
    """The model's units in order: ("mamba", stack path, index) or
    ("shared", group)."""
    if cfg.family == "ssm":
        return [("mamba", ("layers",), (l,)) for l in range(cfg.n_layers)]
    k = cfg.shared_attn_every
    g_n = cfg.n_layers // k
    out = []
    for g in range(g_n):
        out += [("mamba", ("groups",), (g, l)) for l in range(k)]
        out.append(("shared", g))
    out += [("mamba", ("tail",), (l,)) for l in range(cfg.n_layers - g_n * k)]
    return out


def _t_at(tree, path, idx):
    """The port's unit leaf: stack ``path`` of ``tree`` at ``idx``."""
    node = tree[path[0]]
    for i in idx:
        node = tblocks.layer_slice(node, i)
    return node


def _t_cache(jcache):
    """The port's copy of a reference cache (bf16 scales included; the
    reference's absent tail is None)."""
    def conv(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: c for k, c in ((k, conv(v)) for k, v in t.items())
                    if c is not None}
        a = np.asarray(t)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return conv(jcache)


@functools.lru_cache(maxsize=None)
def _j_fns(arch, layers, mode, lut):
    """Jitted reference calls of one configuration (one compile each)."""
    cfg, _, _ = _params(arch, layers, mode)
    jctx, _ = contexts(mode, use_lut=lut)
    jfam, _ = _fams(cfg)
    return {
        "forward": jax.jit(lambda p, t: jfam.forward(p, t, cfg, jctx)[0]),
        "prefill": jax.jit(lambda p, t, c: jfam.prefill(
            p, t, c, cfg, jctx, full_logits=True)),
        "decode": jax.jit(lambda p, t, c, q: jfam.decode_step(
            p, t, c, q, cfg, jctx)),
        "mamba": {d: jax.jit(lambda p, x, st, d=d: jblocks.mamba_block_apply(
            p, x, cfg, jctx, state=st, decode=d)[0]) for d in (False, True)},
        "shared": jax.jit(lambda p, x, c, q: jblocks.dense_block_apply(
            p, x, cfg, jctx, cache=c, cache_pos=q)[0]),
    }


def _unit_outputs(arch, layers, mode, tokens, jcache, pos, decode,
                  lut=False):
    """Per-unit outputs of both packages, each port unit fed the
    reference's input and run on a port copy of the reference's cache
    (like against like)."""
    cfg, jparams, tparams = _params(arch, layers, mode)
    _, tctx = contexts(mode, use_lut=lut)
    fns = _j_fns(arch, layers, mode, lut)
    x = j_embed(jparams["embed"], jnp.asarray(tokens), contexts(mode)[0])
    tcache = None if jcache is None else _t_cache(jcache)
    jpos = None if pos is None else jnp.asarray(pos)
    tpos = None if pos is None else torch.from_numpy(pos)
    for n, unit in enumerate(_units(cfg)):
        tx = torch.from_numpy(np.array(x))
        if unit[0] == "mamba":
            _, path, idx = unit
            if jcache is None:
                jst = tst = None
            else:
                root = (jcache if cfg.family == "ssm"
                        else jcache["ssm"])
                jst = _tree_at(root[path[0]] if cfg.family == "hybrid"
                               else root, *idx)
                troot = tcache if cfg.family == "ssm" else tcache["ssm"]
                tst = _t_at({"s": troot[path[0]] if cfg.family == "hybrid"
                             else troot}, ("s",), idx)
            x = fns["mamba"][decode](_tree_at(jparams[path[0]], *idx), x,
                                     jst)
            ty, _ = tblocks.mamba_block_apply(
                _t_at(tparams, path, idx), tx, cfg, tctx, state=tst,
                decode=decode)
        else:
            g = unit[1]
            jc = None if jcache is None else _tree_at(jcache["attn"], g)
            tc = (None if tcache is None
                  else tblocks.layer_slice(tcache["attn"], g))
            x = fns["shared"](jparams["shared"], x, jc, jpos)
            ty, _ = tblocks.dense_block_apply(tparams["shared"], tx, cfg,
                                              tctx, cache=tc, cache_pos=tpos)
        _check(ty.numpy(), x, mode, f"{cfg.name} {mode} unit {n} {unit}")


@pytest.mark.parametrize("arch,layers,mode",
                         [m + ("none",) for m in MODELS]
                         + [m + ("int8",) for m in MODELS[:2]],
                         ids=[f"{i}-none" for i in IDS]
                         + [f"{i}-int8" for i in IDS[:2]])
def test_cache_free_forward_matches(arch, layers, mode):
    """Per-unit outputs and logits of the cache-free forward (the hybrid's
    attention through ``ops.attention``, the flash kernel's route)."""
    cfg, jparams, tparams = _params(arch, layers, mode)
    jctx, tctx = contexts(mode)
    jfam, tfam = _fams(cfg)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, (B, S)).astype(np.int32)
    _unit_outputs(arch, layers, mode, tokens, None, None, False)
    jl = _j_fns(arch, layers, mode, False)["forward"](jparams,
                                                      jnp.asarray(tokens))
    tl, _ = tfam.forward(tparams, torch.from_numpy(tokens), cfg, tctx)
    _check_model(tl.numpy(), jl, mode, f"{arch} {mode} logits")


def _caches(cfg, paged, kv_dtype):
    """Matching empty caches; paged: disjoint pages per lane, the rest of
    each table on the trash page."""
    jfam, tfam = _fams(cfg)
    jdt = jnp.int8 if kv_dtype == torch.int8 else jnp.float32
    if not paged:
        return (jfam.init_cache(cfg, B, MAX_LEN, jdt),
                tfam.init_cache(cfg, B, MAX_LEN, kv_dtype, device="cpu"))
    bt = np.full((B, WIDTH), NUM_PAGES, np.int32)
    bt[0, :6] = [3, 11, 0, 7, 15, 2]
    bt[1, :6] = [1, 4, 9, 5, 8, 12]
    jc = japi.set_block_table(
        jfam.init_paged_cache(cfg, B, NUM_PAGES, PS, WIDTH, jdt), bt)
    tc = tapi.set_block_table(
        tfam.init_paged_cache(cfg, B, NUM_PAGES, PS, WIDTH, kv_dtype,
                              device="cpu"), torch.from_numpy(bt))
    return jc, tc


def _ssm_part(cfg, cache):
    return cache if cfg.family == "ssm" else cache["ssm"]


#: (arch, layers, mode, KV dtype, use_lut): one reference run on the
#: dense cache each; the port serves it on its dense and its paged cache
SERVE_CELLS = [
    ("mamba2-370m", None, "none", torch.float32, False),
    ("mamba2-370m", None, "int8", torch.float32, False),
    ("mamba2-370m", None, "none", torch.float32, True),
    ("zamba2-1.2b", None, "none", torch.float32, False),
    ("zamba2-1.2b", None, "int8", torch.float32, False),
    ("zamba2-1.2b", None, "none", torch.int8, False),
    ("zamba2-1.2b", None, "none", torch.float32, True),
    ("zamba2-1.2b", 5, "none", torch.float32, False),
    ("zamba2-1.2b", 5, "int8", torch.float32, False),
]


def _cell_id(c):
    arch, layers, mode, kv, lut = c
    return "-".join([arch.split("-")[0] + ("-tail" if layers else ""), mode]
                    + (["kv8"] if kv == torch.int8 else [])
                    + (["lut"] if lut else []))


@pytest.mark.parametrize("arch,layers,mode,kv,lut", SERVE_CELLS,
                         ids=[_cell_id(c) for c in SERVE_CELLS])
def test_prefill_then_decode_matches(arch, layers, mode, kv, lut):
    """A whole-prompt prefill (S 16, one SSD chunk) and two decode steps
    of the reference on its dense cache, against the port on its dense
    and its paged cache (dense only under the LUT: the reference's dense
    attention takes the table softmax, the paged route the exact one):
    logits of each call and the recurrent states after the prefill;
    per-unit outputs of the prefill and of the first decode step, each
    port unit on a copy of the reference's cache; the port's caches keep
    their tensors.  An int8 KV cache is gated as int8 weights are (a
    K/V value's last bit can move its int8 code)."""
    cfg, jparams, tparams = _params(arch, layers, mode)
    _, tctx = contexts(mode, use_lut=lut)
    _, tfam = _fams(cfg)
    fns = _j_fns(arch, layers, mode, lut)
    gate = "int8" if torch.int8 == kv or mode == "int8" else "none"
    jcache, _ = _caches(cfg, False, kv)
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab, (B, S)).astype(np.int32)
    pos0 = np.zeros((B,), np.int32)
    _unit_outputs(arch, layers, mode, prompt, jcache, pos0, False, lut)
    jl, jcache = fns["prefill"](jparams, jnp.asarray(prompt), jcache)
    jstates = jax.tree_util.tree_leaves(_ssm_part(cfg, jcache))
    want, toks = [np.asarray(jl)], [prompt]
    for step in range(STEPS):
        toks.append(want[-1][:, -1].argmax(-1).astype(np.int32)[:, None])
        if step == 0:
            _unit_outputs(arch, layers, mode, toks[-1], jcache, pos0 + S,
                          True, lut)
        jl, jcache = fns["decode"](jparams, jnp.asarray(toks[-1]), jcache,
                                   jnp.asarray(pos0 + S + step))
        want.append(np.asarray(jl))
    for paged in ((False,) if lut else (False, True)):
        what = f"{_cell_id((arch, layers, mode, kv, lut))} paged={paged}"
        tcache = _caches(cfg, paged, kv)[1]
        addrs = _addresses(tcache)
        tl, tcache = tfam.prefill(tparams, torch.from_numpy(prompt), tcache,
                                  cfg, tctx, full_logits=True)
        _check_model(tl.numpy(), want[0], gate, f"{what} prefill logits")
        tst = [t for _, t in tapi.cache_leaves(_ssm_part(cfg, tcache))]
        assert len(tst) == len(jstates)
        for j, t in zip(jstates, tst):
            _check_model(t.numpy(), j, gate, f"{what} state after prefill")
        for step in range(STEPS):
            tl, tcache = tfam.decode_step(
                tparams, torch.from_numpy(toks[step + 1]), tcache,
                torch.from_numpy(pos0 + S + step), cfg, tctx)
            _check_model(tl.numpy(), want[step + 1], gate,
                         f"{what} decode step {step}")
        assert _addresses(tcache) == addrs


def test_step_builders_prefill_then_decode():
    """``build_prefill_step`` (the whole prompt, every lane's state copied
    in) then ``build_decode_loop`` greedy tokens equal the reference's
    step builders' (f32, mamba2 and zamba2 smoke, paged zamba2)."""
    from repro.train import step as jstep
    from repro_torch.train import step as tstep
    for arch, paged in (("mamba2-370m", False), ("zamba2-1.2b", True)):
        cfg, jparams, tparams = _params(arch, None, "none")
        jctx, tctx = contexts("none")
        jcache, tcache = _caches(cfg, paged, torch.float32)
        prompt = np.random.RandomState(2).randint(
            0, cfg.vocab, (B, S)).astype(np.int32)
        jl, jcache = jax.jit(jstep.build_prefill_step(cfg, jctx))(
            jparams, {"tokens": jnp.asarray(prompt)}, jcache)
        tl, tcache = tstep.build_prefill_step(cfg, tctx)(
            tparams, {"tokens": torch.from_numpy(prompt)}, tcache)
        _check(tl.numpy(), jl, "none", f"{arch} step-builder prefill")
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = np.full((B,), S, np.int32)
        live = np.ones((B,), bool)
        stop = np.full((B,), S + 5, np.int32)
        sp = {"temperature": np.zeros((B,), np.float32),
              "top_k": np.zeros((B,), np.int32)}
        jloop = jax.jit(jstep.build_decode_loop(cfg, jctx, 4),
                        static_argnums=(7,))
        jout = jloop(jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
                     jnp.asarray(live), jnp.asarray(stop),
                     {k: jnp.asarray(v) for k, v in sp.items()}, None, 0, -1)
        tout = tstep.build_decode_loop(cfg, tctx, 4)(
            tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(live), torch.from_numpy(stop),
            {k: torch.from_numpy(v) for k, v in sp.items()}, None, 0, -1)
        np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_configs_counts_and_smoke_equal_the_reference(arch):
    """The config and its smoke reduction field for field (the SSM
    section included), the analytic parameter counts, and the port's own
    init within 2% of ``n_params``."""
    def fields(c):
        d = dataclasses.asdict(c)
        return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                    else v) for k, v in d.items()}
    for c, jc in ((get_config(arch), j_config(arch)),
                  (get_config(arch).smoke(), j_config(arch).smoke())):
        assert fields(c) == fields(jc)
        assert (c.n_params(), c.active_params(), c.flop_params()) \
            == (jc.n_params(), jc.active_params(), jc.flop_params())
        assert (c.ssm.d_inner, c.ssm.n_heads, c.ssm.conv_dim) \
            == (jc.ssm.d_inner, jc.ssm.n_heads, jc.ssm.conv_dim)
    cfg = get_config(arch).smoke()
    params = tapi.get_family(cfg).init(torch.Generator().manual_seed(0), cfg,
                                       device="cpu")
    actual = sum(t.numel() for _, t in tapi.cache_leaves(params))
    assert abs(actual - cfg.n_params()) / actual < 0.02


@pytest.mark.parametrize("arch,layers", MODELS, ids=IDS)
def test_int8_ptq_leaves_what_the_reference_leaves(arch, layers):
    """The port's ``ptq_params`` quantizes exactly the reference's leaves
    (embedding and conv weights stay float; ``A_log``, ``D``, ``dt_bias``
    f32), and the hybrid's (G, k, ...) stacks convert as they are."""
    from repro_torch.core.qtypes import QTensor
    from repro_torch.core.quantize import ptq_params
    cfg, _, tf32 = _params(arch, layers, "none")
    _, j8, t8 = _params(arch, layers, "int8")
    ours = ptq_params(tf32, int8_policies()[1])

    def kinds(tree, path=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(kinds(v, f"{path}/{k}"))
            else:
                out[f"{path}/{k}"] = (isinstance(v, QTensor),
                                      tuple(v.shape), v.dtype)
        return out
    assert kinds(ours) == kinds(t8)
    quantized = sorted(p for p, (q, _, _) in kinds(ours).items() if q)
    assert all(p.endswith("/w") and "embed" not in p for p in quantized)
    for p, (q, shape, dt) in kinds(ours).items():
        if p.rsplit("/", 1)[-1] in ("A_log", "D", "dt_bias"):
            assert dt == torch.float32 and not q
        if "conv_w" in p:
            assert not q
    if cfg.family == "hybrid":
        g, k = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
        assert ours["groups"]["ssm"]["in_proj"]["w"].data.shape[:2] == (g, k)
        assert kinds(t8)["/groups/ssm/in_proj/w"][1][:2] == (g, k)
