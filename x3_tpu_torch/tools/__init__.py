"""The port's tools: GPU analogues of the JAX package's on-chip decode
tools (`python -m x3_tpu_torch.tools.decode_parity`, `fuzz_soak`) and its
host tools with devices in place of engines (`fuzz_differential`,
`roundtrip_corpus`, `bench_files`, `compile_sweep`)."""
