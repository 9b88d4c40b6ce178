"""Multi-process input sharding of the port (x3_tpu.parallel)."""
