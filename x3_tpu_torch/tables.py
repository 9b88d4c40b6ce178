"""Constant tables the kernels read.

The JAX kernels close over numpy constants derived from `Parameters` (the
CRC table, the GF(2) CRC matrix, the Rice decode tables and the Rice
statistics slots).  Here the same numpy values are built (the GF(2) CRC
constants as x3_tpu.ops.crc_jax.crc_matmul_consts builds them) and become
torch tensors on the requested device.  The CRC kernel K1 reads tables of
its own, built from the same CRC table (crc_fold_tables)."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .ops.crc import CRC_TABLE
from .params import Parameters


def _s_apply(v: np.ndarray) -> np.ndarray:
    """One zero-byte advance of the CRC register: S(r) = (r<<8) ^ T[r>>8]."""
    v = np.asarray(v, dtype=np.uint16)
    return (((v << np.uint16(8)) & np.uint16(0xFFFF)) ^ CRC_TABLE[v >> 8]).astype(np.uint16)


def _gf2_invert(cols: np.ndarray) -> np.ndarray:
    """Invert a 16x16 GF(2) matrix given as basis-image columns."""
    m = np.zeros((16, 16), dtype=np.uint8)
    for j in range(16):
        for i in range(16):
            m[i, j] = (int(cols[j]) >> i) & 1
    aug = np.concatenate([m, np.eye(16, dtype=np.uint8)], axis=1)
    for col in range(16):
        pivot = next(r for r in range(col, 16) if aug[r, col])
        aug[[col, pivot]] = aug[[pivot, col]]
        for r in range(16):
            if r != col and aug[r, col]:
                aug[r] ^= aug[col]
    inv = aug[:, 16:]
    out = np.zeros(16, dtype=np.uint16)
    for j in range(16):
        out[j] = int("".join(str(b) for b in inv[::-1, j]), 2)
    return out


def _apply_cols(cols: np.ndarray, v):
    """Apply a GF(2) matrix (basis-image columns) to uint16 values (numpy
    or torch integers)."""
    acc = v * 0
    for b in range(16):
        acc = acc ^ (((v >> b) & 1) * int(cols[b]))
    return acc


@functools.lru_cache(maxsize=8)
def crc_matmul_consts(n_bytes: int):
    """(M, const_init, inv_pows) of the GF(2) CRC over an n_bytes buffer.

    M: int8 [n_bytes*8, 16], the contribution of each input bit (MSB first
       per byte) to each CRC bit; const_init: S^n(0xffff);
    inv_pows: uint16 [n_levels, 16], basis images of S^(-2^k), which undo
       2^k trailing zero bytes."""
    m = np.zeros((n_bytes * 8, 16), dtype=np.int8)
    # The last byte's bit p contributes T[1 << p]; each byte toward the
    # front applies S once more.
    contrib = CRC_TABLE[np.uint8(1) << np.arange(8)].astype(np.uint16)
    for k in range(n_bytes - 1, -1, -1):
        for j in range(8):  # bit j of the byte, MSB first, is p = 7 - j
            m[k * 8 + j] = (int(contrib[7 - j]) >> np.arange(16)) & 1
        contrib = _s_apply(contrib)

    init = np.uint16(0xFFFF)
    for _ in range(n_bytes):
        init = _s_apply(init)

    s_inv = _gf2_invert(_s_apply(np.uint16(1) << np.arange(16, dtype=np.uint16)))
    n_levels = max(1, int(n_bytes).bit_length())
    inv_pows = np.zeros((n_levels, 16), dtype=np.uint16)
    cur = s_inv
    for lvl in range(n_levels):
        inv_pows[lvl] = cur
        cur = np.array([_apply_cols(cur, np.uint16(c)) for c in cur], dtype=np.uint16)
    return m, int(init), inv_pows


class DeviceTables(NamedTuple):
    # int32 [9]: thresholds t0..t2, Rice orders of the three selected codes
    # (params.codes), statistics slot (nsubs) of each selected code.
    enc_consts: torch.Tensor
    # int32 [8]: per-ftype (index 1..3) nsubs [0:4] and inverse-table length
    # [4:8] of the selected Rice codes (decode_kernel._decode_tables).
    dec_consts: torch.Tensor
    rice_nsubs: tuple  # python ints: statistics slot per Rice selection
    dec_nsubs: tuple  # python ints, index = ftype (0 unused)
    dec_invlen: tuple  # python ints, index = ftype (0 unused)


def _decode_tables_np(params: Parameters):
    """Per-ftype (1..3) nsubs and inv_len from the selected Rice codes
    (x3_tpu.ops.decode_kernel._decode_tables)."""
    nsubs = np.zeros(4, dtype=np.int32)
    invlen = np.zeros(4, dtype=np.int32)
    for f in (1, 2, 3):
        rc = params.rice_codes[f - 1]
        nsubs[f] = rc.nsubs
        invlen[f] = rc.inv_len
    return nsubs, invlen


@functools.lru_cache(maxsize=32)
def device_tables(params: Parameters, device) -> DeviceTables:
    """The kernels' parameter tables for `params` on `device`."""
    device = torch.device(device)
    rice_nsubs = tuple(int(rc.nsubs) for rc in params.rice_codes)
    enc = np.asarray(
        list(params.thresholds) + list(params.codes) + list(rice_nsubs), dtype=np.int32
    )
    nsubs, invlen = _decode_tables_np(params)
    dec = np.concatenate([nsubs, invlen]).astype(np.int32)
    return DeviceTables(
        enc_consts=torch.from_numpy(enc).to(device),
        dec_consts=torch.from_numpy(dec).to(device),
        rice_nsubs=rice_nsubs,
        dec_nsubs=tuple(int(x) for x in nsubs),
        dec_invlen=tuple(int(x) for x in invlen),
    )


# Layout of the fold tables (uint16 entries; offsets into crc_fold_tables_np).
# csrc/crc16.cu repeats it as kAHi ... kSeed and kTableSize; a test of
# tests/test_torch_crc.py holds the two equal.
FOLD_LANES = 32  # one warp: lane j reads word 32*s + j at step s
FOLD_STRIPE = 4 * FOLD_LANES  # bytes per step
FOLD_A_HI, FOLD_A_LO = 0, 256  # S^128 of the partial's high / low byte
FOLD_E = 512  # 4 x 256: E_k[b] = S^(3-k) T[b], byte k of a word (k = 0 first)
FOLD_LANE = 1536  # [16, 32]: column b of lane j's S^(4 (31 - j)) at FOLD_LANE + 32 * b + j
FOLD_UNPAD = 2048  # [128, 16]: column b of S^-z at 16 * z + b
FOLD_SEED = 4096  # one entry: S^-124(0xffff), lane 0's partial before step 0
FOLD_SIZE = 4104  # padded to whole 16-byte vectors (the kernel's loads)


def _s_pow_cols(k: int) -> np.ndarray:
    """Basis-image columns of S^k (k >= 0)."""
    cols = np.uint16(1) << np.arange(16, dtype=np.uint16)
    for _ in range(k):
        cols = _s_apply(cols)
    return cols


@functools.lru_cache(maxsize=1)
def crc_fold_tables_np() -> np.ndarray:
    """uint16 [FOLD_SIZE]: the tables of the warp-per-frame CRC kernel
    (csrc/crc16.cu, whose header gives the algebra), at the FOLD_*
    offsets.  S^-z is built from the S^-(2^i) of crc_matmul_consts,
    i = 0..6, and so is the seed S^-124(0xffff)."""
    out = np.zeros(FOLD_SIZE, dtype=np.uint16)
    byte = np.arange(256, dtype=np.uint16)
    a = _s_pow_cols(FOLD_STRIPE)
    out[FOLD_A_HI : FOLD_A_HI + 256] = _apply_cols(a, byte << np.uint16(8))
    out[FOLD_A_LO : FOLD_A_LO + 256] = _apply_cols(a, byte)
    e = CRC_TABLE.astype(np.uint16)
    for k in range(3, -1, -1):
        out[FOLD_E + 256 * k : FOLD_E + 256 * (k + 1)] = e
        e = _s_apply(e)
    for j in range(FOLD_LANES):
        out[FOLD_LANE + j : FOLD_UNPAD : FOLD_LANES] = _s_pow_cols(4 * (FOLD_LANES - 1 - j))
    inv_pows = crc_matmul_consts(FOLD_STRIPE)[2]
    for z in range(FOLD_STRIPE):
        cols = np.uint16(1) << np.arange(16, dtype=np.uint16)
        for lvl in range(7):
            if (z >> lvl) & 1:
                cols = np.array([_apply_cols(inv_pows[lvl], c) for c in cols], dtype=np.uint16)
        out[FOLD_UNPAD + 16 * z : FOLD_UNPAD + 16 * (z + 1)] = cols
    seed = np.uint16(0xFFFF)
    for lvl in (2, 3, 4, 5, 6):  # 124 = 4 + 8 + 16 + 32 + 64
        seed = _apply_cols(inv_pows[lvl], seed)
    out[FOLD_SEED] = seed
    return out


@functools.lru_cache(maxsize=4)
def crc_fold_tables(device) -> torch.Tensor:
    """crc_fold_tables_np as int16 bit patterns on `device`."""
    return torch.from_numpy(crc_fold_tables_np().view(np.int16).copy()).to(torch.device(device))


@functools.lru_cache(maxsize=8)
def crc_consts(n_words: int, device):
    """GF(2) CRC constants for an n_words-word buffer (crc_matmul_consts):
    (M float32 [n_words*32, 16] of 0/1, const_init int, inv_pows uint16
    numpy [n_levels, 16]).  M is float32 so the plain product runs on any
    device; its 0/1 sums stay below 2**24 and are exact."""
    m, const_init, inv_pows = crc_matmul_consts(n_words * 4)
    mt = torch.from_numpy(m.astype(np.float32)).to(torch.device(device))
    return mt, int(const_init), inv_pows
