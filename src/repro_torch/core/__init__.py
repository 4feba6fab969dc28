"""Numeric formats, quantizers, constant tables and the op registry."""
