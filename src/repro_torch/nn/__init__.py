"""Layers of the dense ``lm`` family: linear, norms, RoPE, embedding,
paged GQA attention and the transformer block."""
