"""TPColumnwise (all-gather + GEMM) implementations."""
