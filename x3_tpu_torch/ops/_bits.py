"""32-bit word arithmetic on torch integer tensors.

Torch's CPU uint32 has no shift, add or compare, so the plain versions
carry 32-bit words as int64 holding 0..2**32-1 and hand them to the
kernels, and back to callers, as int32 bit patterns."""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int64 0..2**32-1 view of int32 bit patterns (or of int64 words)."""
    return x.to(torch.int64) & MASK32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern of int64 words (values taken mod 2**32)."""
    x = x & MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits needed for non-negative int64 values below 2**53 (0 -> 0)."""
    _, e = torch.frexp(x.to(torch.float64))
    return torch.where(x > 0, e.to(torch.int64), torch.zeros_like(x))


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit words held as int64 (clz(0) = 32)."""
    return 32 - bit_length(x)


def wrap16(v: torch.Tensor) -> torch.Tensor:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def stage_mask(hi: int) -> int:
    """Index bits a log-depth barrel over indices 0..hi looks at: its
    stages are the powers of two <= hi, so higher index bits are ignored
    (x3_tpu.ops.decode_kernel._barrel)."""
    return (1 << max(hi, 0).bit_length()) - 1


def check_tensor(t: torch.Tensor, name: str, dtype, ndim: int, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of rank `ndim` on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
