"""EPAllToAll (all-to-all + expert GEMM + all-to-all) implementations."""
