"""DPAllReduce (GEMM + all-reduce) implementations."""
