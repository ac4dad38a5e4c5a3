"""transformer_step: the flagship model's training step as a primitive."""
