"""command-r-35b -- dense GQA, parallel attention/FFN block, no biases
[hf:CohereForAI/c4ai-command-r-v01; unverified: the reference's config,
copied verbatim].

40L, d_model 8192, 64 heads (GQA kv=8), d_ff 22528, vocab 256000.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="lm",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="layernorm",
    norm_eps=1e-5,
    parallel_block=True,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
)
