"""TPRowwise (GEMM + reduce-scatter) implementations."""
