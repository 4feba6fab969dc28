"""gemma-2b -- dense, GeGLU, MQA (kv=1), head_dim 256 [arXiv:2403.08295; hf].

18L, d_model 2048, 8 heads, d_ff 16384, vocab 256000.  Embeddings tied and
scaled by sqrt(d); RMSNorm uses the (1 + scale) form.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="lm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    mlp_act="gelu",
    mlp_gated=True,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    norm_plus_one=True,
    embed_scale=True,
    tie_embeddings=True,
)
