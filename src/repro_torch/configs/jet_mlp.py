"""jet-mlp -- the paper's canonical hls4ml use case: the 3-hidden-layer
fully-connected jet-tagging classifier from the original hls4ml
publication (Duarte et al., JINST 13 (2018)): 16 -> 64 -> 32 -> 32 -> 5.

Encoded as a ModelConfig for uniformity but consumed by
``repro_torch.models.mlp`` directly (no serving family).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jet-mlp",
    family="mlp",
    n_layers=3,
    d_model=64,             # widest hidden layer
    vocab=5,                # output classes
    d_ff=16,                # input features
    norm_type="rmsnorm",
    tie_embeddings=False,
)

#: hidden layer widths, input features, classes -- the exact hls4ml model
HIDDEN = (64, 32, 32)
N_FEATURES = 16
N_CLASSES = 5
