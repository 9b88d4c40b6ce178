"""x3_tpu_torch's payload CRC (plain version of kernel K1) against x3_tpu:
crc16_words_jax, the Pallas CRC kernel in interpret mode, crc16_many and
the reference's golden vectors.  Exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from x3_tpu.ops.crc import crc16, crc16_many


def _words_with_lengths(rng, F, n_words, zero_tail=True):
    words = rng.integers(0, 1 << 32, (F, n_words), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, 4 * n_words + 1, F).astype(np.int32)
    lengths[0], lengths[-1] = 0, 4 * n_words
    if zero_tail:
        by = words.byteswap().view(np.uint8).reshape(F, 4 * n_words)
        for i, n in enumerate(lengths):
            by[i, n:] = 0
        words = by.view(np.uint32).byteswap().reshape(F, n_words)
    return words, lengths


def _port(words, lengths, n_words):
    from x3_tpu_torch.ops.crc_torch import crc16_words

    got = crc16_words(torch.from_numpy(words.view(np.int32)), torch.from_numpy(lengths), n_words)
    assert got.dtype == torch.int32
    return got.numpy()


def _rows(words):
    return np.ascontiguousarray(words).byteswap().view(np.uint8).reshape(words.shape[0], -1)


@pytest.mark.parametrize("n_words", [1, 2, 7, 24, 130])
def test_crc_matches_jax_and_numpy(rng, n_words):
    import jax.numpy as jnp

    from x3_tpu.ops.crc_jax import crc16_words_jax

    words, lengths = _words_with_lengths(rng, 9, n_words)
    got = _port(words, lengths, n_words)
    want = np.asarray(crc16_words_jax(jnp.asarray(words), jnp.asarray(lengths), n_words))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, crc16_many(_rows(words), lengths))


def test_crc_matches_pallas_kernel_interpret(rng):
    """Same contract as crc_planes_pallas (interpret mode) + _crc16_finish."""
    import jax.numpy as jnp

    import x3_tpu.ops.crc_pallas as cp
    from x3_tpu.ops.crc_jax import _crc16_finish, crc_matmul_consts

    orig = (cp.F_TILE, cp.CW)
    cp.F_TILE, cp.CW = 2, 4
    try:
        w = 8
        words, lengths = _words_with_lengths(rng, 6, w)
        m, const_init, inv = crc_matmul_consts(w * 4)
        mk = np.ascontiguousarray(cp.permute_m_rows(m, w).T)
        planes = np.asarray(cp.crc_planes_pallas(jnp.asarray(words), jnp.asarray(mk), w, True)) & 1
        want = np.asarray(
            _crc16_finish(jnp.asarray(planes), jnp.asarray(lengths), const_init, inv, w * 4)
        )
    finally:
        cp.F_TILE, cp.CW = orig
    np.testing.assert_array_equal(_port(words, lengths, w), want)


def test_crc_ignores_bytes_past_length(rng):
    """Non-zero tails: the port returns the CRC of the leading bytes (the
    kernel never reads past the length; the plain version masks)."""
    words, lengths = _words_with_lengths(rng, 11, 5, zero_tail=False)
    rows = _rows(words)
    want = [crc16(rows[i, : lengths[i]].tobytes()) for i in range(len(rows))]
    assert _port(words, lengths, 5).tolist() == want


def test_crc_clamps_lengths(rng):
    words, _ = _words_with_lengths(rng, 4, 3)
    lengths = np.asarray([-5, 0, 12, 99], np.int32)
    rows = _rows(words)
    want = [0xFFFF, 0xFFFF, crc16(rows[2].tobytes()), crc16(rows[3].tobytes())]
    assert _port(words, lengths, 3).tolist() == want


@pytest.mark.parametrize("key,value,n", [("crc_header", 0xADDB, 16), ("crc_payload", 2073, None)])
def test_crc_golden_vectors(golden, key, value, n):
    data = bytes(golden[key])[:n]
    n_words = -(-len(data) // 4)
    buf = np.zeros(4 * n_words, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    words = buf.view(">u4").astype(np.uint32)[None, :]
    got = _port(words, np.asarray([len(data)], np.int32), n_words)
    assert got.tolist() == [value]


def test_crc_rejects_width_mismatch():
    from x3_tpu_torch.ops.crc_torch import crc16_words

    with pytest.raises(ValueError):
        crc16_words(torch.zeros((2, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 5)
