"""Batched payload CRC16 over big-endian word rows (x3_tpu.ops.crc_jax).

`crc16_words` is the contract of crc16_words_jax: CRC-16/CCITT (init
0xffff) of the first `lengths[f]` bytes of each row of big-endian 32-bit
words.  A CUDA tensor goes to the CRC kernel (ops/crc_cuda.py); a CPU
tensor to the plain version below, which keeps the JAX package's GF(2)
formulation: the data part is bits(words) @ M over GF(2), and the trailing
zero padding is undone by S^-z (crc_jax._crc16_finish)."""

from __future__ import annotations

import torch

from x3_tpu.ops.crc_jax import _apply_cols

from ..tables import crc_consts
from ._bits import MASK32, as_i32, u32


def crc16_words(words: torch.Tensor, lengths: torch.Tensor, n_words: int) -> torch.Tensor:
    """CRC16 of each row's leading `lengths[f]` bytes.

    words: int32 [F, n_words] bit patterns of big-endian payload words.
    lengths: int32 [F] byte counts, clamped to 0..4*n_words.
    Returns int32 [F] holding uint16 values."""
    if words.is_cuda:
        from .crc_cuda import crc16_words_cuda

        return crc16_words_cuda(words, lengths, n_words)
    return crc16_words_plain(words, lengths, n_words)


def _mask_past_length(w: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero every byte at or past each row's length (int64 words)."""
    n_words = w.shape[1]
    base = torch.arange(n_words, device=w.device, dtype=torch.int64)[None, :] * 4
    keep = (lengths.to(torch.int64)[:, None] - base).clamp(0, 4)  # bytes kept per word
    mask = (torch.full_like(keep, MASK32) << (32 - 8 * keep)) & MASK32
    return w & mask


def crc16_words_plain(words: torch.Tensor, lengths: torch.Tensor, n_words: int) -> torch.Tensor:
    """Plain PyTorch version of the CRC kernel: GF(2) product plus S^-z.

    Bytes past a row's length are zeroed first, so the result is the CRC
    of the leading bytes whatever the tail holds (the JAX function asks the
    caller for a zero tail; with one both agree)."""
    F, W = words.shape
    if W != n_words:
        raise ValueError(f"words has {W} columns, n_words is {n_words}")
    n_bytes = 4 * n_words
    lengths = lengths.to(torch.int64).clamp(0, n_bytes)
    w = _mask_past_length(u32(words), lengths)
    m, const_init, inv_pows = crc_consts(n_words, words.device)
    shifts = torch.arange(31, -1, -1, device=words.device, dtype=torch.int64)
    bits = ((w[:, :, None] >> shifts) & 1).to(torch.float32).reshape(F, n_words * 32)
    planes = (bits @ m).to(torch.int64) & 1
    weights = 1 << torch.arange(16, device=words.device, dtype=torch.int64)
    crc = (planes * weights).sum(dim=1) ^ const_init
    z = n_bytes - lengths
    for lvl in range(inv_pows.shape[0]):
        applied = _apply_cols(inv_pows[lvl], crc)
        crc = torch.where(((z >> lvl) & 1) == 1, applied, crc)
    return as_i32(crc & 0xFFFF)
