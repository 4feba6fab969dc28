"""Step builders for serving and the CUDA-graph dispatch of the decode
block (training is not ported yet)."""
