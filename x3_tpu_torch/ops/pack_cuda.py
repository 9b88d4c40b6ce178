"""The level-1 block pack K5 (csrc/pack_blocks.cu) and its plain version.

Replaces x3_tpu/ops/pack_pallas.py::pack_blocks_pallas: for each (frame,
block) lane, the block's I items are written MSB-first from the lane's
in-superword offset r2 into nb4 word slots; pieces at slot nb4 or later
are dropped.  Lanes are the minor axis.  `pack_blocks` routes a CUDA
tensor to the kernel and a CPU tensor to the plain version."""

from __future__ import annotations

import torch

from ._bits import as_i32, bit_pieces, check_tensor, u32
from ._build import check_launch, load

SOURCE = "x3_tpu_torch/csrc/pack_blocks.cu"
REPLACES = "x3_tpu/ops/pack_pallas.py:28"
launch_count = 0  # launches of the kernel since the last reset

MAX_NB4 = 40  # the slots of a lane (the kernel's shared tile holds 40 a thread)


def _check(item_val, item_len, r2, nb4, dev):
    check_tensor(item_val, "item_val", torch.int32, 2, dev)
    check_tensor(item_len, "item_len", torch.int32, 2, dev)
    check_tensor(r2, "r2", torch.int32, 2, dev)
    N = item_val.shape[1]
    if item_len.shape != item_val.shape or tuple(r2.shape) != (1, N):
        raise ValueError(f"shape mismatch: item_val {tuple(item_val.shape)}, item_len "
                         f"{tuple(item_len.shape)}, r2 {tuple(r2.shape)}")
    if not 0 < nb4 <= MAX_NB4:
        raise ValueError(f"nb4 {nb4} outside 1..{MAX_NB4}")


def pack_blocks_plain(item_val: torch.Tensor, item_len: torch.Tensor, r2: torch.Tensor, nb4: int):
    """Plain PyTorch version of K5, on any device.

    item_val int32 [I, N] (u32 bit patterns), item_len int32 [I, N] (0..32
    bits, 0 = absent), r2 int32 [1, N] (the block's bit offset in its
    superword).  Returns int32 [nb4, N]: slot w holds the 32-bit sum of the
    pieces aimed at it (the pieces of a well-formed block are
    bit-disjoint, so the sum is their OR)."""
    _check(item_val, item_len, r2, nb4, item_val.device)
    N = item_val.shape[1]
    ln = item_len.to(torch.int64)
    poff = r2.to(torch.int64) + ln.cumsum(dim=0) - ln
    hi, lo = bit_pieces(u32(item_val), ln, poff)
    t = poff >> 5
    out = torch.zeros((nb4 + 1, N), dtype=torch.int64, device=item_val.device)
    out.scatter_add_(0, t.clamp(max=nb4), hi)  # row nb4 collects dropped pieces
    out.scatter_add_(0, (t + 1).clamp(max=nb4), lo)
    return as_i32(out[:nb4])


plain = pack_blocks_plain


def pack_blocks_cuda(item_val: torch.Tensor, item_len: torch.Tensor, r2: torch.Tensor, nb4: int):
    """K5 on CUDA tensors; same contract as pack_blocks_plain."""
    global launch_count
    dev = item_val.device
    if dev.type != "cuda":
        raise ValueError("pack_blocks_cuda takes CUDA tensors")
    _check(item_val, item_len, r2, nb4, dev)
    I, N = item_val.shape
    out = torch.empty((nb4, N), dtype=torch.int32, device=dev)
    if N:
        with torch.cuda.device(dev):  # the raw launch goes to the current device
            fn = load("pack_blocks", "x3_pack_blocks", 4, 3)
            rc = fn(item_val.data_ptr(), item_len.data_ptr(), r2.data_ptr(), out.data_ptr(),
                    I, N, nb4, torch.cuda.current_stream(dev).cuda_stream)
        check_launch(rc, "pack_blocks_cuda")
        launch_count += 1
    return out


def pack_blocks(item_val, item_len, r2, nb4: int):
    """K5 for CUDA tensors, its plain version for CPU tensors."""
    fn = pack_blocks_cuda if item_val.is_cuda else pack_blocks_plain
    return fn(item_val, item_len, r2, nb4)
