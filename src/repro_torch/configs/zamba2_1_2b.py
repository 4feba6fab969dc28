"""zamba2-1.2b -- hybrid: a Mamba-2 backbone with ONE shared transformer
block re-applied every 6 layers [arXiv:2411.15242; hf].

38 mamba layers, d_model 2048, ssm_state 64; shared block: 32 heads
(MHA kv=32), d_ff 8192; vocab 32000.  Upstream concatenates the original
embedding into the shared block and applies per-use LoRA deltas; the
reference (and so the port) uses a plain residual with exact sharing.
"""

from ..models.config import ModelConfig
from ..nn.ssm import SSMDims

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    mlp_act="gelu",
    mlp_gated=True,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    shared_attn_every=6,
    ssm=SSMDims(d_model=2048, d_state=64, head_dim=64, expand=2,
                n_groups=1, d_conv=4, chunk=256),
)
