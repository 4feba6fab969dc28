"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356;
unverified].  Conv frontend is a STUB per the brief: ``input_specs``
provides precomputed frame embeddings (B, S_enc, 512).

6+6L, d_model 512, 8 heads (MHA: kv=8), d_ff 2048, vocab 51865.
LayerNorm, plain GeLU MLP, learned decoder positions, sinusoidal encoder
positions.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    mlp_act="gelu",
    mlp_gated=False,
    norm_type="layernorm",
    norm_eps=1e-5,
    pos_type="learned",
    max_position=32768,      # decoder learned-position table (stressed shapes)
    enc_len_cap=4096,
    tie_embeddings=True,
)
