"""Checkpoints in the port's own format."""
