"""Serving trainer, checkpoints in the JAX format, metrics."""
