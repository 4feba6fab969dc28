"""deepseek-v2-236b -- MoE with multi-head latent attention
[arXiv:2405.04434; hf].

60L, d_model 5120, 128 heads, MLA kv_lora 512 (+64 rope), q_lora 1536;
MoE: 160 routed experts top-6 (d_ff_expert 1536) + 2 shared, first layer
dense (d_ff 12288), vocab 102400.  routed_scaling_factor 16 with top-k
renormalization off in upstream v2; the reference keeps
renormalize=True + routed_scale 1.0 (equivalent magnitude), and so does
this copy.
"""

from ..models.config import ModelConfig, MoEConfig
from ..nn.attention import MLADims

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="lm",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,           # informational; MLA dims below drive attention
    d_ff=12288,             # the leading dense layer's FFN
    vocab=102400,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    tie_embeddings=False,
    attn_kind="mla",
    mla=MLADims(d_model=5120, n_heads=128, q_lora_rank=1536,
                kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                  first_k_dense=1, renormalize=True,
                  capacity_factor=1.25, aux_loss_weight=0.003),
)
