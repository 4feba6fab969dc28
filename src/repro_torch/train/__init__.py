"""Step builders for training and serving, and the CUDA-graph dispatch of
the decode block."""
