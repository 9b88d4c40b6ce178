"""Wrapper of the decode kernel K3 (csrc/decode.cu).

Replaces x3_tpu/ops/decode_pallas.py::_decode_pallas_impl (with its
wrapper's sample 0 and overrun check): one thread per frame walks the
frame's payload words and writes int16 samples, the error code and the
final bit offset.  The plain version it is held against is
decode_kernel.decode_words_plain."""

from __future__ import annotations

import torch

from x3_tpu.params import Parameters

from ..tables import device_tables
from ._bits import check_tensor
from ._build import check_launch, load
from .decode_kernel import decode_geometry_of, decode_words_plain

SOURCE = "x3_tpu_torch/csrc/decode.cu"
REPLACES = "x3_tpu/ops/decode_pallas.py:269"
plain = decode_words_plain
launch_count = 0  # launches of the kernel since the last reset


def decode_words_cuda(words: torch.Tensor, n_samples: torch.Tensor, payload_lens: torch.Tensor,
                      params: Parameters, n_blocks: int | None = None):
    """K3 on CUDA tensors: int32 [F, W] words, int32 [F] sample counts and
    payload lengths -> (samples int16 [F, S], err int32 [F], final bit
    offset int32 [F]); same contract as decode_words_plain."""
    global launch_count
    dev = words.device
    if dev.type != "cuda":
        raise ValueError("decode_words_cuda takes CUDA tensors")
    check_tensor(words, "words", torch.int32, 2, dev)
    check_tensor(n_samples, "n_samples", torch.int32, 1, dev)
    check_tensor(payload_lens, "payload_lens", torch.int32, 1, dev)
    F, W = words.shape
    if W < 1 or n_samples.shape[0] != F or payload_lens.shape[0] != F:
        raise ValueError(f"shape mismatch: words {tuple(words.shape)}, n_samples "
                         f"{tuple(n_samples.shape)}, payload_lens {tuple(payload_lens.shape)}")
    S, B, L, WFULL, WIN = decode_geometry_of(params, n_blocks)
    out = torch.empty((F, S), dtype=torch.int16, device=dev)
    err = torch.empty(F, dtype=torch.int32, device=dev)
    off = torch.empty(F, dtype=torch.int32, device=dev)
    if F:
        with torch.cuda.device(dev):  # the raw launch goes to the current device
            fn = load("decode", "x3_decode_frames", 7, 7)
            rc = fn(words.data_ptr(), n_samples.data_ptr(), payload_lens.data_ptr(),
                    device_tables(params, dev).dec_consts.data_ptr(), out.data_ptr(),
                    err.data_ptr(), off.data_ptr(), F, W, S, B, L, WIN, WFULL,
                    torch.cuda.current_stream(dev).cuda_stream)
        check_launch(rc, "decode_words_cuda")
        launch_count += 1
    return out, err, off
