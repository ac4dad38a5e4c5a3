"""transformer_decode: the flagship model's serving step as a primitive."""
