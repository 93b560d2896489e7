"""Plain references the benchmark holds the program against: float32
PyTorch with no kernel, cache or batching, importing nothing of the program
(`repro_torch`) or of the JAX package."""
