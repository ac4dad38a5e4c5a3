"""PPPipeline (pipeline-parallel staged GEMM chain) implementations."""
