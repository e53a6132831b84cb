"""Checkpoints in the JAX package's file format (``io``)."""
