"""GPU analogues of the JAX package's on-chip decode tools: `python -m
x3_tpu_torch.tools.decode_parity` and `python -m x3_tpu_torch.tools.fuzz_soak`."""
