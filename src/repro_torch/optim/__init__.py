"""Local optimizers."""
