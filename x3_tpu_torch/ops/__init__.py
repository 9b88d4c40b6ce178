"""Device kernels of the port: the plain PyTorch versions and the CUDA
wrappers (crc_cuda, encode_cuda, decode_cuda) beside them."""
