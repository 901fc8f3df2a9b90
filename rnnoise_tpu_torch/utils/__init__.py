"""State checkpoints, metrics and debugging aids."""
