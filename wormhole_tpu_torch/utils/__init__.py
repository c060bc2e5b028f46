"""Model checkpoints."""
