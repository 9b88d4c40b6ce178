"""The pair pack K6 (csrc/pack_walk.cu) and its plain version.

Replaces x3_tpu/ops/pack_walk_pallas.py::pack_frames_walk: the pairs of
each block (<= 32-bit pre-merged items) are written MSB-first from the
block's absolute bit offset into the frame's W payload words.  Each block
spans at most NB words (walk_buffer_words); pieces past them, and pieces
at word W or later, are dropped.  For frames that fit W the words equal
encode_kernel._pack_pairs'.  `pack_frames_walk` routes a CUDA tensor to
the kernel and a CPU tensor to the plain version."""

from __future__ import annotations

import torch

from ._bits import as_i32, bit_pieces, check_tensor, u32
from ._build import check_launch, load

SOURCE = "x3_tpu_torch/csrc/pack_walk.cu"
REPLACES = "x3_tpu/ops/pack_walk_pallas.py:117"
launch_count = 0  # launches of the kernel since the last reset

MAX_NB = 32  # the words one block may span (the contract's limit)
MAX_WORDS = (227 * 1024) // 4  # a frame's W words live in shared memory (227 KB on sm_90)


def walk_buffer_words(L: int) -> int:
    """NB: the words one block can span from its worst in-word start.
    Block 0 starts at bit 0 with <= 16+6+16L bits; any other block starts
    at an in-word offset <= 31 with <= 6+16L bits."""
    return max(-(-(16 + 6 + 16 * L) // 32), -(-(31 + 6 + 16 * L) // 32))


def _check(mval, mlen, block_off, W, L, dev):
    check_tensor(mval, "mval", torch.int32, 3, dev)
    check_tensor(mlen, "mlen", torch.int32, 3, dev)
    check_tensor(block_off, "block_off", torch.int32, 2, dev)
    if mlen.shape != mval.shape or tuple(block_off.shape) != tuple(mval.shape[:2]):
        raise ValueError(f"shape mismatch: mval {tuple(mval.shape)}, mlen {tuple(mlen.shape)}, "
                         f"block_off {tuple(block_off.shape)}")
    if not 0 < W <= MAX_WORDS:
        raise ValueError(f"payload width {W} words outside 1..{MAX_WORDS}")
    if not 0 < walk_buffer_words(L) <= MAX_NB:
        raise ValueError(f"block length {L}: a block spans more than {MAX_NB} words")


def pack_walk_plain(mval: torch.Tensor, mlen: torch.Tensor, block_off: torch.Tensor, W: int, L: int):
    """Plain PyTorch version of K6, on any device.

    mval int32 [F, B, P] (u32 bit patterns), mlen int32 [F, B, P] (0..32
    bits), block_off int32 [F, B] (each block's absolute bit offset), L the
    block length (it sizes NB).  Returns int32 [F, W]: each word the 32-bit
    sum of the pieces aimed at it (their OR for well-formed pairs)."""
    _check(mval, mlen, block_off, W, L, mval.device)
    F, B, P = mval.shape
    NB = walk_buffer_words(L)
    ln = mlen.to(torch.int64)
    boff = block_off.to(torch.int64)[:, :, None]
    poff = (boff & 31) + ln.cumsum(dim=2) - ln  # bit offset in the block's words
    hi, lo = bit_pieces(u32(mval), ln, poff)
    t = poff >> 5
    hi = torch.where(t < NB, hi, 0)
    lo = torch.where(t + 1 < NB, lo, 0)
    word = (boff >> 5) + t
    stride = W + 1  # column W collects dropped pieces
    base = torch.arange(F, device=mval.device)[:, None, None] * stride
    flat = torch.zeros(F * stride, dtype=torch.int64, device=mval.device)
    flat.index_add_(0, (base + word.clamp(max=W)).reshape(-1), hi.reshape(-1))
    flat.index_add_(0, (base + (word + 1).clamp(max=W)).reshape(-1), lo.reshape(-1))
    return as_i32(flat.reshape(F, stride)[:, :W])


plain = pack_walk_plain


def pack_walk_cuda(mval: torch.Tensor, mlen: torch.Tensor, block_off: torch.Tensor, W: int, L: int):
    """K6 on CUDA tensors; same contract as pack_walk_plain."""
    global launch_count
    dev = mval.device
    if dev.type != "cuda":
        raise ValueError("pack_walk_cuda takes CUDA tensors")
    _check(mval, mlen, block_off, W, L, dev)
    F, B, P = mval.shape
    out = torch.empty((F, W), dtype=torch.int32, device=dev)
    if F:
        with torch.cuda.device(dev):  # the raw launch goes to the current device
            fn = load("pack_walk", "x3_pack_walk", 4, 5)
            rc = fn(mval.data_ptr(), mlen.data_ptr(), block_off.data_ptr(), out.data_ptr(),
                    F, B, P, W, walk_buffer_words(L), torch.cuda.current_stream(dev).cuda_stream)
        check_launch(rc, "pack_walk_cuda")
        launch_count += 1
    return out


def pack_frames_walk(mval, mlen, block_off, W: int, L: int):
    """K6 for CUDA tensors, its plain version for CPU tensors."""
    fn = pack_walk_cuda if mval.is_cuda else pack_walk_plain
    return fn(mval, mlen, block_off, W, L)
