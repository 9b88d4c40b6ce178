"""CRC-16/CCITT on the host (poly 0x1021, init 0xffff, MSB first), as
x3_tpu.ops.crc computes it: the byte table, the CRC of one byte string and
a CRC of many byte rows at once (one numpy table gather per byte
position); and the port's CRC of many rows of one even length, two bytes
a gather (crc16_pairs)."""

from __future__ import annotations

import numpy as np


def _build_table() -> np.ndarray:
    poly = 0x1021
    table = np.zeros(256, dtype=np.uint16)
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & 0x8000) else (crc << 1)
            crc &= 0xFFFF
        table[i] = crc
    return table


CRC_TABLE = _build_table()
_TABLE = tuple(int(x) for x in CRC_TABLE)  # python ints: the scalar loop's fast path


def crc16(data) -> int:
    """CRC16 of a byte string, init 0xffff."""
    crc = 0xFFFF
    for b in bytes(data):
        crc = ((crc << 8) ^ _TABLE[(b ^ (crc >> 8)) & 0xFF]) & 0xFFFF
    return crc


def crc16_many(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC16 of many byte rows at once.

    rows: uint8 [N, max_len]; lengths: int [N] valid bytes per row.  Returns
    uint16 [N].  Bytes past a row's length do not affect its CRC."""
    rows = np.asarray(rows, dtype=np.uint8)
    lengths = np.asarray(lengths)
    n = rows.shape[0]
    crc = np.full(n, 0xFFFF, dtype=np.uint16)
    if n == 0:
        return crc
    for i in range(int(lengths.max()) if lengths.size else 0):
        lookup = (rows[:, i] ^ (crc >> 8).astype(np.uint8)).astype(np.int64)
        updated = ((crc << np.uint16(8)) ^ CRC_TABLE[lookup]).astype(np.uint16)
        crc = np.where(i < lengths, updated, crc)
    return crc


def _build_pair_table() -> np.ndarray:
    # Two bytes b0, b1 into register r give T2[r ^ (b0 << 8 | b1)]: after
    # 16 shifts no bit of r is left but through that XOR.
    v = np.arange(1 << 16)
    t_hi = CRC_TABLE[v >> 8].astype(np.int64)
    return (((t_hi & 0xFF) << 8) ^ CRC_TABLE[(v & 0xFF) ^ (t_hi >> 8)]).astype(np.uint16)


_PAIR_TABLE = _build_pair_table()


def crc16_pairs(rows: np.ndarray) -> np.ndarray:
    """crc16_many of uint8 rows [N, 2k] that are all of their full length,
    two bytes a table gather (8 gathers for a 16-byte frame header, where
    crc16_many makes 16 rounds of a dozen numpy calls).  Returns uint16
    [N]."""
    rows = np.asarray(rows, dtype=np.uint8)
    pairs = (rows[:, 0::2].astype(np.int64) << 8) | rows[:, 1::2]
    crc = np.full(rows.shape[0], 0xFFFF, dtype=np.int64)
    for j in range(pairs.shape[1]):
        crc = _PAIR_TABLE[crc ^ pairs[:, j]].astype(np.int64)
    return crc.astype(np.uint16)
