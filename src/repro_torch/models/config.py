"""Architecture configuration (copy of ``repro.models.config``).

The dataclass keeps the reference's fields so configs read the same,
with the MoE and MLA sections (:class:`MoEConfig`,
:class:`~repro_torch.nn.attention.MLADims`) and the analytic parameter
counts; the recurrent families' section is
:class:`~repro_torch.nn.ssm.SSMDims`, the port's own copy of the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..nn.attention import AttnDims, MLADims
from ..nn.ssm import SSMDims

__all__ = ["MoEConfig", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # deepseek: always-on shared experts
    first_k_dense: int = 0       # deepseek: leading dense layers
    renormalize: bool = True
    capacity_factor: float = 1.25
    routed_scale: float = 1.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # lm | encdec | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    mlp_act: str = "silu"
    mlp_gated: bool = True
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-6
    norm_plus_one: bool = False
    parallel_block: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = True
    embed_scale: bool = False
    pos_type: str = "rope"
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    max_position: int = 1 << 19
    attn_kind: str = "gqa"
    mla: Optional[MLADims] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMDims] = None
    shared_attn_every: int = 0
    cross_attn_every: int = 0
    n_img_tokens: int = 1024
    enc_layers: int = 0
    enc_len_cap: int = 4096
    remat: str = "full"
    scan_layers: bool = True

    def attn_dims(self, *, causal: bool = True, use_rope: bool = True
                  ) -> AttnDims:
        return AttnDims(d_model=self.d_model, n_heads=self.n_heads,
                        n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                        rope_theta=self.rope_theta,
                        rope_fraction=self.rope_fraction,
                        use_rope=use_rope and self.pos_type == "rope",
                        qkv_bias=self.qkv_bias, causal=causal)

    def n_params(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.pos_type == "learned":
            total += self.max_position * d

        def dense_ffn(ff):
            return d * ff * (3 if self.mlp_gated else 2)

        def attn_params():
            if self.attn_kind == "mla":
                m = self.mla
                return (d * m.q_lora_rank
                        + m.q_lora_rank * self.n_heads * m.qk_dim
                        + d * (m.kv_lora_rank + m.qk_rope_dim)
                        + m.kv_lora_rank * self.n_heads
                        * (m.qk_nope_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * d)
            hq = self.n_heads * self.head_dim
            hkv = self.n_kv_heads * self.head_dim
            return d * hq + 2 * d * hkv + hq * d

        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            per = (d * (2 * s.d_inner + 2 * s.n_groups * s.d_state
                        + s.n_heads)
                   + s.d_conv * s.conv_dim + s.d_inner * d + 3 * s.n_heads
                   + s.d_inner)
            total += self.n_layers * per
            if self.family == "hybrid" and self.shared_attn_every:
                total += attn_params() + dense_ffn(self.d_ff)
            return total

        per_dense = attn_params() + dense_ffn(self.d_ff)
        if self.moe is not None:
            m = self.moe
            per_moe = (attn_params() + d * m.n_experts
                       + m.n_experts * 3 * d * m.d_ff_expert
                       + 3 * d * m.d_ff_expert * m.n_shared)
            n_moe = self.n_layers - m.first_k_dense
            total += m.first_k_dense * per_dense + n_moe * per_moe
        else:
            total += self.n_layers * per_dense
        if self.family == "encdec":
            total += self.enc_layers * per_dense
            total += self.n_layers * (2 * d * self.n_kv_heads * self.head_dim
                                      + 2 * d * self.n_heads * self.head_dim)
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            n_self = self.n_layers - n_cross
            total = (v * d + n_self * per_dense
                     + n_cross * (attn_params() + dense_ffn(self.d_ff)))
        return total

    def active_params(self) -> int:
        """Activated parameters per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        n_moe = self.n_layers - m.first_k_dense
        inactive = (n_moe * (m.n_experts - m.top_k) * 3 * self.d_model
                    * m.d_ff_expert)
        return self.n_params() - inactive

    def flop_params(self) -> int:
        """Active params that take part in matmuls: an untied input table
        and a learned position table are gathers, not matmuls."""
        n = self.active_params()
        if not self.tie_embeddings:
            n -= self.vocab * self.d_model
        if self.pos_type == "learned":
            n -= self.max_position * self.d_model
        return n

    def smoke(self) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests (the
        reference's reductions)."""
        kw = dict(name=self.name + "-smoke", n_layers=min(self.n_layers, 2),
                  d_model=128, vocab=512, d_ff=256 if self.d_ff else 0,
                  max_position=4096, enc_layers=min(self.enc_layers, 2),
                  n_img_tokens=16, enc_len_cap=64, remat="none")
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=max(1, 4 * self.n_kv_heads
                                                // max(self.n_heads, 1)),
                      head_dim=32)
        if self.mla is not None:
            kw["mla"] = MLADims(d_model=128, n_heads=4, q_lora_rank=64,
                                kv_lora_rank=32, qk_nope_dim=32,
                                qk_rope_dim=16, v_head_dim=32)
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64, n_shared=min(self.moe.n_shared, 1),
                first_k_dense=min(self.moe.first_k_dense, 1))
        if self.ssm is not None:
            kw["ssm"] = SSMDims(d_model=128, d_state=16, head_dim=32,
                                expand=2, n_groups=1, d_conv=4, chunk=16)
        if self.shared_attn_every:
            kw["n_layers"] = 4
            kw["shared_attn_every"] = 2
        if self.cross_attn_every:
            kw["n_layers"] = 4
            kw["cross_attn_every"] = 2
        return dataclasses.replace(self, **kw)
