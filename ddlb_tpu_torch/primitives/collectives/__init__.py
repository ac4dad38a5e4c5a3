"""Collectives (the pure communication micro-benchmark) implementations."""
