"""Hand-written Hopper kernels of the port, each beside its plain version."""
