"""glm4-9b -- dense GQA with qkv bias and partial rotary
[hf:THUDM/glm-4-9b; hf].

40L, d_model 4096, 32 heads (GQA kv=2), d_ff 13696, vocab 151552.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="lm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="rmsnorm",
    norm_eps=1.5625e-07,
    qkv_bias=True,
    rope_fraction=0.5,
    tie_embeddings=False,
)
