"""Wrapper of the CRC kernel K1 (csrc/crc16.cu).

Replaces x3_tpu/ops/crc_pallas.py::crc_planes_pallas (with crc_jax.
_crc16_finish's un-padding): one thread per frame computes the CRC16 of
the row's leading bytes from the byte table in shared memory.  The plain
version it is held against is crc_torch.crc16_words_plain."""

from __future__ import annotations

import torch

from ..tables import crc_table
from ._bits import check_tensor
from ._build import check_launch, load
from .crc_torch import crc16_words_plain

SOURCE = "x3_tpu_torch/csrc/crc16.cu"
REPLACES = "x3_tpu/ops/crc_pallas.py:47"
plain = crc16_words_plain
launch_count = 0  # launches of the kernel since the last reset


def crc16_words_cuda(words: torch.Tensor, lengths: torch.Tensor, n_words: int) -> torch.Tensor:
    """K1 on CUDA tensors: int32 [F, n_words] words, int32 [F] lengths ->
    int32 [F] CRC16 of each row's first lengths[f] bytes (clamped to the
    row)."""
    global launch_count
    dev = words.device
    if dev.type != "cuda":
        raise ValueError("crc16_words_cuda takes CUDA tensors")
    check_tensor(words, "words", torch.int32, 2, dev)
    check_tensor(lengths, "lengths", torch.int32, 1, dev)
    F, W = words.shape
    if W != n_words or lengths.shape[0] != F:
        raise ValueError(f"shape mismatch: words {tuple(words.shape)}, lengths "
                         f"{tuple(lengths.shape)}, n_words {n_words}")
    out = torch.empty(F, dtype=torch.int32, device=dev)
    if F == 0:
        return out
    with torch.cuda.device(dev):  # the raw launch goes to the current device
        fn = load("crc16", "x3_crc16_words", 4, 2)
        rc = fn(words.data_ptr(), lengths.data_ptr(), crc_table(dev).data_ptr(), out.data_ptr(),
                F, W, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "crc16_words_cuda")
    launch_count += 1
    return out
