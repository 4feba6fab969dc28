"""Synthetic token sources (port of the serving prompts' source)."""
