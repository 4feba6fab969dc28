"""mamba2-370m -- attention-free SSD state-space model [arXiv:2405.21060;
unverified].

48L, d_model 1024, ssm_state 128, vocab 50280.  d_inner = 2048,
head_dim 64 -> 32 SSD heads.
"""

from ..models.config import ModelConfig
from ..nn.ssm import SSMDims

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    vocab=50280,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    ssm=SSMDims(d_model=1024, d_state=128, head_dim=64, expand=2,
                n_groups=1, d_conv=4, chunk=256),
)
