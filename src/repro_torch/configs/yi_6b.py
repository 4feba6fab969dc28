"""yi-6b -- dense llama-arch GQA [arXiv:2403.04652; hf].

32L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="lm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab=64000,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
)
