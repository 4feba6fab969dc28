"""llama-3.2-vision-11b -- VLM: dense GQA text stack with gated
cross-attention image layers every 5th layer [hf:meta-llama/
Llama-3.2-11B-Vision; unverified].  The vision front end is a stub, as
in the reference: ``img_embed`` carries precomputed patch embeddings.

40L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 128256.
``tie_embeddings`` is False as in the reference's config, but the
reference's VLM unembeds against the embedding table and has no head
(``repro_torch.models.vlm``), and ``n_params`` counts none.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    rope_theta=500_000.0,
    tie_embeddings=False,
    cross_attn_every=5,
    n_img_tokens=1601,      # one 560x560 tile -> 1601 patch tokens
)
