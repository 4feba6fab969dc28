"""The cache-free flash attention: port vs ``repro``.

The port's two plain versions -- ``flash_attention_ref`` (the reference's
oracle: ``-inf`` mask, full softmax) and ``flash_attention_plain`` (the
CUDA kernel's arithmetic: online softmax over 64-row K/V tiles, ``-1e30``
mask, ``l`` floored at 1e-30) -- against the reference's
``flash_attention_ref`` and ``flash_attention_pallas(interpret=True)`` at
small blocks (bq 8, bk 16), over causal and not, GQA groups 1/2/4, Sq and
Skv that are not block multiples (Sq < Skv and Sq > Skv), head dims 32
and 64, a set ``softmax_scale``, f32 and bf16.

Tolerances: f32 atol = rtol = 1e-5 (sums in another order); bf16 one
bf16 ulp of the output (both sides round f32 values that differ in the
last f32 bits) plus the f32 lane's atol, for outputs that cancel to near
0, where the f32 values themselves may differ by 1e-6 (a 1% difference
at an output of 8e-5 was seen).  A causal query row that sees no key
(Sq > Skv) is NaN in both oracles and exactly 0 in the kernels (TPU and
plain).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.ref import flash_attention_ref as j_ref  # noqa: E402
from repro_torch.kernels import launch_counts, ops  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_plain,  # noqa: E402
                                     flash_attention_ref)

F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _operands(b, hq, hkv, sq, skv, d, seed, dv=None):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, hq, sq, d).astype(np.float32)
    k = rs.randn(b, hkv, skv, d).astype(np.float32)
    v = rs.randn(b, hkv, skv, dv or d).astype(np.float32)
    return q, k, v


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    got, want = got.astype(np.float32), want.astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        err = np.abs(got - want)
        bad = err > _bf16_ulp(want) + F32_TOL["atol"]
        assert not bad.any(), (f"{bad.sum()} of {bad.size} beyond one bf16 "
                               f"ulp, max err {err.max()}")


def _run_all(q, k, v, dtype, *, causal, scale):
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a, dtype=getattr(torch, dtype))
                  for a in (q, k, v))
    pal = flash_attention_pallas(jq, jk, jv, causal=causal,
                                 softmax_scale=scale, bq=8, bk=16,
                                 interpret=True)
    oracle = j_ref(jq, jk, jv, causal=causal, softmax_scale=scale)
    plain = flash_attention_plain(tq, tk, tv, causal=causal,
                                  softmax_scale=scale)
    ref = flash_attention_ref(tq, tk, tv, causal=causal, softmax_scale=scale)
    for t in (plain, ref):
        assert t.dtype == tq.dtype and t.shape == tq.shape
    return (np.asarray(pal.astype(jnp.float32)),
            np.asarray(oracle.astype(jnp.float32)), plain.float().numpy(),
            ref.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,scale", [(32, None), (64, 0.3)])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq,skv", [(13, 29), (29, 13), (37, 37)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_reference_and_pallas(causal, sq, skv, group, d,
                                                   scale, dtype):
    q, k, v = _operands(2, 2 * group, 2, sq, skv, d,
                        seed=sq * 7 + skv + group + d)
    pal, oracle, plain, ref = _run_all(q, k, v, dtype, causal=causal,
                                       scale=scale)
    # the plain version of the kernel against the TPU kernel, everywhere
    _close(plain, pal, dtype)
    # both port versions against the reference's oracle where it is
    # defined; rows that see no key: NaN in both oracles, 0 in the kernels
    seen = np.isfinite(oracle)
    assert (not causal or sq <= skv) == seen.all()
    _close(plain[seen], oracle[seen], dtype)
    _close(ref[seen], oracle[seen], dtype)
    assert np.isnan(ref[~seen]).all()
    assert (plain[~seen] == 0).all() and (pal[~seen] == 0).all()


def test_mla_width_with_zero_padded_values():
    """MLA's naive prefill: head dim 192, V zero-padded from 128, causal."""
    q, k, v = _operands(1, 4, 4, 40, 40, 192, seed=5, dv=128)
    v = np.concatenate([v, np.zeros((1, 4, 40, 64), np.float32)], axis=-1)
    pal, oracle, plain, _ = _run_all(q, k, v, "float32", causal=True,
                                     scale=None)
    _close(plain, pal, "float32")
    _close(plain, oracle, "float32")
    assert (plain[..., 128:] == 0).all()


def test_more_tiles_than_the_kernel_block():
    """Skv past several of the kernel's 64-row tiles, causal, Sq < Skv:
    the online update across tiles, and tiles no query sees."""
    q, k, v = _operands(1, 2, 1, 70, 150, 32, seed=6)
    pal, oracle, plain, _ = _run_all(q, k, v, "float32", causal=True,
                                     scale=None)
    _close(plain, pal, "float32")
    _close(plain, oracle, "float32")


def test_ops_dispatch_and_no_launch_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _operands(1, 4, 2, 9, 11, 32, 7))
    before = launch_counts()["flash_attention"]
    torch.testing.assert_close(ops.attention(q, k, v, causal=True),
                               flash_attention_plain(q, k, v, causal=True),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        ops.attention(q, k, v, causal=False, backend="ref"),
        flash_attention_ref(q, k, v, causal=False), rtol=0, atol=0)
    assert launch_counts()["flash_attention"] == before


def test_wrapper_refuses_other_devices():
    """The wrapper runs the plain version only for CPU tensors; anything
    else launches the kernel or raises (here: the meta device)."""
    q, k, v = (torch.from_numpy(a).to("meta")
               for a in _operands(1, 2, 1, 4, 4, 32, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention(q, k, v)


# -- why the tensor-core kernel feeds p to p.v as three bf16 terms --------
def _plain_before(q, k, v, *, causal, softmax_scale=None):
    """``flash_attention_plain`` as the CUDA-core kernel's plain version
    was first written, op for op: the plain version of both kernels must
    stay bitwise this."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = (softmax_scale if softmax_scale is not None
             else float(1.0 / np.sqrt(d)))
    qf = q.reshape(b, hkv, hq // hkv, sq, d).to(torch.float32) * scale
    qpos = (skv - sq) + torch.arange(sq)[:, None]
    m = torch.full((b, hkv, hq // hkv, sq, 1), -1e30, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, sq, v.shape[-1]),
                      dtype=torch.float32)
    for k0 in range(0, skv, 64):
        kt = k[:, :, k0:k0 + 64].to(torch.float32)
        vt = v[:, :, k0:k0 + 64].to(torch.float32)
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt)
        if causal:
            mask = qpos >= k0 + torch.arange(kt.shape[2])
            logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        if causal:
            p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhgqk,bhkd->bhgqd", p, vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,causal", [(29, 130, True), (130, 29, True),
                                           (64, 64, False)])
def test_plain_version_is_bitwise_unchanged(dtype, sq, skv, causal):
    """The tensor-core kernel keeps the plain version's arithmetic, so the
    plain version (the f32 and bf16 lanes', every CPU route's) is bitwise
    what it was."""
    q, k, v = (torch.tensor(a, dtype=getattr(torch, dtype))
               for a in _operands(2, 4, 2, sq, skv, 32, seed=11))
    assert torch.equal(flash_attention_plain(q, k, v, causal=causal),
                       _plain_before(q, k, v, causal=causal))


def _terms(p: torch.Tensor, n: int) -> torch.Tensor:
    """p as the sum of ``n`` bf16 terms, each the bf16 rounding of what
    the earlier ones left (the kernel's split of p, n = 3)."""
    out, rest = torch.zeros_like(p), p
    for _ in range(n):
        t = rest.to(torch.bfloat16).to(torch.float32)
        out, rest = out + t, rest - t
    return out


def test_three_bf16_terms_carry_p_exactly():
    """hi + mi + lo = p bit for bit over the softmax's range of p (1 down
    to 2^-100, across exponents), so P.V on the tensor cores multiplies
    the plain version's f32 p; one term keeps 8 bits, two keep 16."""
    rs = np.random.RandomState(1)
    p = torch.tensor(np.exp2(-rs.uniform(0, 100, 200000)), dtype=torch.float32)
    assert torch.equal(_terms(p, 3), p)
    rel = ((_terms(p, 2) - p) / p).abs().max().item()
    assert 0 < rel <= 2.0 ** -17
    assert ((_terms(p, 1) - p) / p).abs().max().item() > 2.0 ** -10


def _online(q, k, v, logits_fn, n_terms):
    """The online softmax over 64-row tiles with the logits from
    ``logits_fn``, p entering p.v as ``n_terms`` bf16 terms."""
    qf = q.float() * q.shape[-1] ** -0.5
    b, h, sq, d = q.shape
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, k.shape[2], 64):
        kt, vt = k[:, :, k0:k0 + 64].float(), v[:, :, k0:k0 + 64].float()
        s = logits_fn(qf, kt)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd",
                                         _terms(p, n_terms), vt)
        m = m_new
    return acc / l.clamp_min(1e-30)


def test_one_bf16_term_of_p_follows_the_logits_summation_order():
    """Two summation orders of the same logits (f32 and f64 sums,
    whisper-encoder rows of 1500 keys at D 64) move a single bf16 rounding
    of p across rounding boundaries and outputs by up to ~7e-5, beyond
    the kernel's gate of one bf16 output ulp + 2e-5 at outputs near 0;
    with the kernel's three terms the two orders stay at f32 noise and
    inside the gate everywhere."""
    rs = np.random.RandomState(0)
    q, k, v = (torch.tensor(rs.randn(1, 2, 1500, 64), dtype=torch.bfloat16)
               for _ in range(3))

    def f32(qf, kt):
        return torch.einsum("bhqd,bhkd->bhqk", qf, kt)

    def f64(qf, kt):
        return torch.einsum("bhqd,bhkd->bhqk", qf.double(),
                            kt.double()).float()

    delta = {}
    for n in (1, 3):
        a, b = _online(q, k, v, f32, n), _online(q, k, v, f64, n)
        delta[n] = (a - b).abs().max().item()
        if n == 3:
            _close(b.bfloat16().float().numpy(),
                   a.bfloat16().float().numpy(), "bfloat16")
    assert delta[3] < 2e-6
    assert delta[1] > 2e-5 and delta[1] > 10 * delta[3]
