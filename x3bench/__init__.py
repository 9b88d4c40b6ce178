"""x3bench: the benchmark of x3_tpu_torch (see README.md)."""
