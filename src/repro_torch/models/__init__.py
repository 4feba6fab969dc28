"""Model configuration and the dense ``lm`` family."""
