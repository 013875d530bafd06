"""Full-state checkpoints of the flat-buffer engine."""
