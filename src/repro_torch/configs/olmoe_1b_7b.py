"""olmoe-1b-7b -- MoE, 64 experts top-8 [arXiv:2409.02060; hf].

16L, d_model 2048, 16 heads (MHA: kv=16), d_ff_expert 1024, vocab 50304.
"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="lm",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,              # informational; all FFNs are MoE
    vocab=50304,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, n_shared=0,
                  first_k_dense=0, renormalize=False,
                  capacity_factor=1.25, aux_loss_weight=0.01),
)
