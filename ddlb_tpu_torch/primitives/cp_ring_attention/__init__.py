"""CPRingAttention (context-parallel causal attention) implementations."""
