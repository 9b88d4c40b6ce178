"""Wrapper of the encode kernel K2 (csrc/encode.cu).

Replaces x3_tpu/ops/encode_fused_pallas.py::encode_frames_fused_words:
one CUDA block per frame turns int16 samples into the frame's payload
words, total_bits, blockfit_bits, nbytes and statistics in one pass.  The
plain version it is held against is encode_kernel.encode_words_plain."""

from __future__ import annotations

import torch

from x3_tpu.params import Parameters

from ..tables import device_tables
from ._bits import check_tensor
from ._build import check_launch, load
from .encode_kernel import encode_words_plain, frame_geometry

SOURCE = "x3_tpu_torch/csrc/encode.cu"
REPLACES = "x3_tpu/ops/encode_fused_pallas.py:141"
plain = encode_words_plain
launch_count = 0  # launches of the kernel since the last reset

# A frame's W words live in shared memory (at most 227 KB a block).
MAX_WORDS = (227 * 1024) // 4


def encode_words_cuda(samples: torch.Tensor, n_valid: torch.Tensor, params: Parameters, W: int):
    """K2 on CUDA tensors: int16 [F, S] samples, int32 [F] n_valid ->
    (words int32 [F, W], total_bits, blockfit_bits, nbytes int32 [F],
    stats int32 [F, 6]); same contract as encode_words_plain."""
    global launch_count
    dev = samples.device
    if dev.type != "cuda":
        raise ValueError("encode_words_cuda takes CUDA tensors")
    check_tensor(samples, "samples", torch.int16, 2, dev)
    check_tensor(n_valid, "n_valid", torch.int32, 1, dev)
    S, B, L, _ = frame_geometry(params)
    F = samples.shape[0]
    if samples.shape[1] != S or n_valid.shape[0] != F:
        raise ValueError(f"expected samples [F, {S}] and n_valid [F], got "
                         f"{tuple(samples.shape)} and {tuple(n_valid.shape)}")
    if not 0 < W <= MAX_WORDS:
        raise ValueError(f"payload width {W} words outside 1..{MAX_WORDS}")
    i32 = dict(dtype=torch.int32, device=dev)
    words = torch.empty((F, W), **i32)
    total_bits = torch.empty(F, **i32)
    blockfit = torch.empty(F, **i32)
    nbytes = torch.empty(F, **i32)
    stats = torch.empty((F, 6), **i32)
    if F:
        with torch.cuda.device(dev):  # the raw launch goes to the current device
            fn = load("encode", "x3_encode_frames", 8, 5)
            rc = fn(samples.data_ptr(), n_valid.data_ptr(),
                    device_tables(params, dev).enc_consts.data_ptr(),
                    words.data_ptr(), total_bits.data_ptr(), blockfit.data_ptr(),
                    nbytes.data_ptr(), stats.data_ptr(), F, S, B, L, W,
                    torch.cuda.current_stream(dev).cuda_stream)
        check_launch(rc, "encode_words_cuda")
        launch_count += 1
    return words, total_bits, blockfit, nbytes, stats
