"""Public kernel API with backend dispatch (port of ``repro.kernels.ops``).

Same signatures as the reference.  ``backend=None`` takes the ambient or
default backend, which is ``cuda``: the kernel wrappers, which run the
plain version for CPU tensors and the Hopper kernel for CUDA tensors.
``backend="ref"`` asks for the plain version explicitly, on any device
(``chip_smoke.py`` uses it to hold the kernels against it on the card).

Under autograd (training under ``--lut`` and ``--quant int8``) the table
ops, ``quantize_rows`` and ``qmatmul`` run as autograd functions over the
backend's forward and its backward op (``<op>_bwd``): the backward
kernels' wrappers for ``cuda``, the plain backward for ``ref`` (and for
CPU tensors).  Without a gradient to take they call the forward alone.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..core.registry import get_impl, register_op
from ..core.tables import TableSpec
from . import ref as _ref
from .flash_attention import flash_attention as _flash_attention_cuda
from .flash_attention import paged_attention as _paged_attention_cuda
from .lut_activation import LutActivationFn, LutGatedMulFn
from .lut_activation import lut_activation as _lut_activation_cuda
from .lut_activation import lut_activation_bwd as _lut_activation_bwd_cuda
from .lut_activation import lut_gated_mul as _lut_gated_mul_cuda
from .lut_activation import lut_gated_mul_bwd as _lut_gated_mul_bwd_cuda
from .qmatmul import QmatmulFn
from .qmatmul import qmatmul as _qmatmul_cuda
from .qmatmul import qmatmul_bwd as _qmatmul_bwd_cuda
from .quantize_rows import QuantizeRowsFn
from .quantize_rows import quantize_rows as _quantize_rows_cuda
from .quantize_rows import quantize_rows_bwd as _quantize_rows_bwd_cuda
from .sampling import sample_tokens_fused as _sample_tokens_fused
from .speculative import verify_tokens_fused as _verify_tokens_fused

__all__ = ["lut_activation", "lut_gated_mul", "quantize_rows", "qmatmul",
           "attention", "paged_attention", "sample_tokens", "verify_tokens"]

register_op("lut_activation", "ref")(_ref.lut_activation_ref)
register_op("lut_activation", "cuda")(_lut_activation_cuda)
# the gated MLP's table pass and the int8 activation quantizer: the
# reference leaves both to XLA fusions (no Pallas kernel); the port runs
# each as one hand-written kernel
register_op("lut_gated_mul", "ref")(_ref.lut_gated_mul_ref)
register_op("lut_gated_mul", "cuda")(_lut_gated_mul_cuda)
register_op("quantize_rows", "ref")(_ref.quantize_rows_ref)
register_op("quantize_rows", "cuda")(_quantize_rows_cuda)
register_op("qmatmul", "ref")(_ref.qmatmul_ref)
register_op("qmatmul", "cuda")(_qmatmul_cuda)
# their backward ops (training): the plain backward, the backward kernels
register_op("lut_activation_bwd", "ref")(_ref.lut_activation_bwd_plain)
register_op("lut_activation_bwd", "cuda")(_lut_activation_bwd_cuda)
register_op("lut_gated_mul_bwd", "ref")(_ref.lut_gated_mul_bwd_plain)
register_op("lut_gated_mul_bwd", "cuda")(_lut_gated_mul_bwd_cuda)
register_op("quantize_rows_bwd", "ref")(_ref.quantize_rows_bwd_plain)
register_op("quantize_rows_bwd", "cuda")(_quantize_rows_bwd_cuda)
register_op("qmatmul_bwd", "ref")(_ref.qmatmul_bwd_plain)
register_op("qmatmul_bwd", "cuda")(_qmatmul_bwd_cuda)
register_op("attention", "ref")(_ref.flash_attention_ref)
register_op("attention", "cuda")(_flash_attention_cuda)
register_op("paged_attention", "ref")(_ref.paged_attention_ref)
register_op("paged_attention", "cuda")(_paged_attention_cuda)
# sampling: the reference leaves it to XLA (no Pallas kernel), the port to
# PyTorch ops on the device (argmax, argsort, the threefry noise)
register_op("sample_tokens", "ref")(_ref.sample_tokens_ref)
register_op("sample_tokens", "cuda")(_sample_tokens_fused)
# draft verification, likewise XLA's in the reference and PyTorch ops here
register_op("verify_tokens", "ref")(_ref.verify_tokens_ref)
register_op("verify_tokens", "cuda")(_verify_tokens_fused)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def lut_activation(x: torch.Tensor, spec: TableSpec, *,
                   backend: Optional[str] = None, **kw) -> torch.Tensor:
    """Elementwise table lookup of ``x`` through ``spec``'s table."""
    fwd = get_impl("lut_activation", backend)
    if kw:
        fwd = functools.partial(fwd, **kw)
    if not _needs_grad(x):
        return fwd(x, spec)
    return LutActivationFn.apply(x, spec, fwd,
                                 get_impl("lut_activation_bwd", backend))


def lut_gated_mul(g: torch.Tensor, up: torch.Tensor, spec: TableSpec, *,
                  backend: Optional[str] = None) -> torch.Tensor:
    """The gated MLP's table pass: ``((g * T(g)).to(g.dtype)) * up`` with
    ``spec``'s (gated-form) table ``T``."""
    fwd = get_impl("lut_gated_mul", backend)
    if not _needs_grad(g, up):
        return fwd(g, up, spec)
    return LutGatedMulFn.apply(g, up, spec, fwd,
                               get_impl("lut_gated_mul_bwd", backend))


def quantize_rows(x: torch.Tensor, qtype, *, backend: Optional[str] = None):
    """Per-row dynamic quantization of ``x`` (T, K): ``(q, s)`` with ``s``
    (T, 1) f32 and ``q = clamp(round(x / s))`` in ``qtype``'s storage."""
    fwd = get_impl("quantize_rows", backend)
    if not _needs_grad(x):
        return fwd(x, qtype)
    return QuantizeRowsFn.apply(x, qtype, fwd,
                                get_impl("quantize_rows_bwd", backend))


def qmatmul(a_data, b_data, a_scale, b_scale, *, bias=None,
            act_spec: Optional[TableSpec] = None, act_gated: bool = False,
            out_dtype=torch.float32, backend: Optional[str] = None,
            **kw) -> torch.Tensor:
    """Quantized matmul with optional fused epilogue (bias + LUT act).
    Under autograd the scales and the bias get gradients (the int8
    payloads none)."""
    kw = dict(kw, out_dtype=out_dtype)
    if act_spec is not None:
        kw.update(act_spec=act_spec, act_gated=act_gated)
    impl = get_impl("qmatmul", backend)
    if not _needs_grad(a_scale, b_scale, bias):
        if bias is not None:
            kw["bias"] = bias
        return impl(a_data, b_data, a_scale, b_scale, **kw)
    bwd_impl = get_impl("qmatmul_bwd", backend)

    def fwd(a, b, sa, sb, bias_):
        return impl(a, b, sa, sb, **(kw if bias_ is None
                                     else dict(kw, bias=bias_)))

    def bwd(a, b, sa, sb, bias_, dout):
        return bwd_impl(a, b, sa, sb, bias_, dout, act_spec=act_spec,
                        act_gated=act_gated)

    sa, sb = (torch.as_tensor(s, dtype=torch.float32, device=a_data.device)
              for s in (a_scale, b_scale))
    return QmatmulFn.apply(a_data, b_data, sa, sb, bias, fwd, bwd)


def attention(q, k, v, *, causal: bool = True, softmax_scale=None,
              backend: Optional[str] = None, **kw) -> torch.Tensor:
    """Cache-free attention, q (B, Hq, Sq, D) against k, v (B, Hkv, Skv,
    D): the ``flash_attention`` kernel (``cuda``; under autograd on CUDA
    tensors an autograd function whose gradient is the
    ``flash_attention_bwd`` kernel) or the reference's plain oracle
    (``ref``, differentiated by autograd)."""
    return get_impl("attention", backend)(q, k, v, causal=causal,
                                          softmax_scale=softmax_scale, **kw)


def paged_attention(q, k_pages, v_pages, block_tables, qpos, *,
                    softmax_scale=None, kv_split: Optional[int] = None,
                    pages_per_step: Optional[int] = None,
                    backend: Optional[str] = None, **kw) -> torch.Tensor:
    """Attention over a block-table-indexed KV page pool (see
    :func:`repro_torch.kernels.ref.paged_attention_ref` for the contract).

    ``kv_split``/``pages_per_step``: the split-KV knob (None = the cost
    model's choice).  ``(1, 1)`` is the unsplit kernel.
    """
    if kv_split is not None:
        kw["kv_split"] = kv_split
    if pages_per_step is not None:
        kw["pages_per_step"] = pages_per_step
    return get_impl("paged_attention", backend)(
        q, k_pages, v_pages, block_tables, qpos,
        softmax_scale=softmax_scale, **kw)


def sample_tokens(logits, temperature, top_k, key=None, *,
                  backend: Optional[str] = None) -> torch.Tensor:
    """Per-slot next-token draw: (B, V) logits -> (B,) int32 ids.

    ``temperature`` (B,) f32 (<= 0 is greedy) and ``top_k`` (B,) int32
    (<= 0 is unrestricted) are per slot; ``key`` (a
    :mod:`~repro_torch.kernels.prng` key) may be None only when every
    slot is greedy.  See :mod:`repro_torch.kernels.sampling`."""
    return get_impl("sample_tokens", backend)(logits, temperature, top_k,
                                              key)


def verify_tokens(logits, draft, temperature, top_k, key=None, *,
                  backend: Optional[str] = None):
    """Speculative acceptance rule: (B, S, V) target logits over a drafted
    block x (B, S - 1) draft ids -> (next_token (B,), n_advance (B,) in
    [1, S]).  Greedy slots accept the longest prefix of the argmax chain
    (the committed stream is the plain decoder's); sampled slots run
    point-mass rejection sampling.  See
    :mod:`repro_torch.kernels.speculative`."""
    return get_impl("verify_tokens", backend)(logits, draft, temperature,
                                              top_k, key)
