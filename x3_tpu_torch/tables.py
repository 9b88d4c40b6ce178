"""Constant tables the kernels read, built from the JAX package's sources.

The JAX kernels close over numpy constants derived from `Parameters` (the
CRC table, the GF(2) CRC matrix, the Rice decode tables and the Rice
statistics slots).  Here the same numpy values become torch tensors on the
requested device, so both packages compute from one `Parameters` and one
set of numpy constants."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from x3_tpu.ops.crc import CRC_TABLE
from x3_tpu.ops.crc_jax import crc_matmul_consts
from x3_tpu.params import Parameters


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
    (same values as x3_tpu.ops.decode_kernel._decode_tables)."""
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


@functools.lru_cache(maxsize=4)
def crc_table(device) -> torch.Tensor:
    """CRC-16/CCITT byte table (x3_tpu.ops.crc.CRC_TABLE) as int32 [256]."""
    return torch.from_numpy(CRC_TABLE.astype(np.int32)).to(torch.device(device))


@functools.lru_cache(maxsize=8)
def crc_consts(n_words: int, device):
    """GF(2) CRC constants for an n_words-word buffer (crc_matmul_consts):
    (M float32 [n_words*32, 16] of 0/1, const_init int, inv_pows uint16
    numpy [n_levels, 16]).  M is float32 so the plain product runs on any
    device; its 0/1 sums stay below 2**24 and are exact."""
    m, const_init, inv_pows = crc_matmul_consts(n_words * 4)
    mt = torch.from_numpy(m.astype(np.float32)).to(torch.device(device))
    return mt, int(const_init), inv_pows
