"""Architecture configuration (copy of ``repro.models.config``).

The dataclass keeps the reference's fields so configs read the same;
the family sections this slice does not run (MoE, MLA, SSM) stay
``None``, and :meth:`ModelConfig.smoke` refuses a config that sets them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..nn.attention import AttnDims

__all__ = ["ModelConfig"]


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
    mla: Optional[object] = None
    moe: Optional[object] = None
    ssm: Optional[object] = None
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

    def smoke(self) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests (the
        reference's reduction for the dense ``lm`` case)."""
        if self.mla is not None or self.moe is not None or self.ssm is not None:
            raise NotImplementedError("only dense lm configs are ported")
        kw = dict(name=self.name + "-smoke", n_layers=min(self.n_layers, 2),
                  d_model=128, vocab=512, d_ff=256 if self.d_ff else 0,
                  max_position=4096, enc_layers=min(self.enc_layers, 2),
                  n_img_tokens=16, enc_len_cap=64, remat="none")
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=max(1, 4 * self.n_kv_heads
                                                // max(self.n_heads, 1)),
                      head_dim=32)
        return dataclasses.replace(self, **kw)
