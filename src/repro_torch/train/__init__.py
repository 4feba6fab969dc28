"""Step builders for serving (training is not ported yet)."""
