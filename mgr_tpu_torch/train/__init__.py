"""Eval / predict / decode steps (the serving path)."""
