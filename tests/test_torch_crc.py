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


def _fold_model(words, lengths):
    """The CRC kernel's arithmetic (csrc/crc16.cu) in numpy, on the tables
    the wrapper passes it: a warp per frame, lane j reading word 32 s + j at
    step s, masked at the length; p = A(p) ^ E0..E3 per step, lane 0 seeded
    with S^-124(0xffff); each lane's partial advanced to the stripe's end,
    XOR-reduced over the warp, then S^-z."""
    from x3_tpu_torch import tables as t

    tab = t.crc_fold_tables("cpu").numpy().view(np.uint16).astype(np.int64)
    F, W = words.shape
    n = np.clip(lengths.astype(np.int64), 0, 4 * W)
    nw, steps = (n + 3) >> 2, (n + 127) >> 7
    lane = np.arange(32)
    w64 = words.astype(np.int64)
    p = np.zeros((F, 32), np.int64)
    p[:, 0] = tab[t.FOLD_SEED]
    for s in range(int(steps.max(initial=0))):
        i = 32 * s + lane[None, :]
        w = np.where(i < nw[:, None], w64[np.arange(F)[:, None], np.minimum(i, W - 1)], 0)
        keep = np.clip(n[:, None] - 4 * i, 0, 4)
        x = w & ((0xFFFFFFFF << (32 - 8 * keep)) & 0xFFFFFFFF)
        e = tab[t.FOLD_E + (x >> 24)] ^ tab[t.FOLD_E + 256 + ((x >> 16) & 0xFF)] \
            ^ tab[t.FOLD_E + 512 + ((x >> 8) & 0xFF)] ^ tab[t.FOLD_E + 768 + (x & 0xFF)]
        step = tab[t.FOLD_A_HI + (p >> 8)] ^ tab[t.FOLD_A_LO + (p & 0xFF)] ^ e
        p = np.where((s < steps)[:, None], step, p)
    r = np.zeros(F, np.int64)
    for b in range(16):
        r ^= np.bitwise_xor.reduce(((p >> b) & 1) * tab[t.FOLD_LANE + 32 * b + lane], axis=1)
    z = 128 * steps - n
    crc = np.zeros(F, np.int64)
    for b in range(16):
        crc ^= ((r >> b) & 1) * tab[t.FOLD_UNPAD + 16 * z + b]
    return crc


@pytest.mark.parametrize("lengths", ["0..300", "4W", "negative", "above 4W"])
@pytest.mark.parametrize("n_words", [1, 5, 130])
def test_crc_fold_model_matches_crc16_many(rng, n_words, lengths):
    """The kernel's fold, modelled in numpy on its own tables, equals the
    byte-serial CRC on every length, with junk past each length."""
    cases = {"0..300": np.arange(301), "4W": [4 * n_words, 4 * n_words - 1, 4 * n_words - 5],
             "negative": [-1, -4, -129, -(2**31)], "above 4W": [4 * n_words + 1, 4 * n_words + 128, 2**31 - 1]}
    lens = np.asarray(cases[lengths], np.int64).astype(np.int32)
    words = rng.integers(0, 1 << 32, (len(lens), n_words), dtype=np.uint64).astype(np.uint32)
    want = crc16_many(_rows(words), np.clip(lens, 0, 4 * n_words))
    np.testing.assert_array_equal(_fold_model(words, lens), want)


def test_crc_fold_layout_matches_the_kernel():
    """csrc/crc16.cu's table offsets and size are tables.FOLD_*: the kernel
    reads the entries the wrapper's tables hold, and copies all of them."""
    import re
    from pathlib import Path

    from x3_tpu_torch import tables as t

    src = (Path(t.__file__).parent / "csrc" / "crc16.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"\bk(AHi|ALo|E|Lane|Unpad|Seed|TableSize) = (\d+)\b", src)}
    assert got == {"AHi": t.FOLD_A_HI, "ALo": t.FOLD_A_LO, "E": t.FOLD_E, "Lane": t.FOLD_LANE,
                   "Unpad": t.FOLD_UNPAD, "Seed": t.FOLD_SEED, "TableSize": t.FOLD_SIZE}
    assert t.FOLD_SIZE % 8 == 0 and t.FOLD_SEED < t.FOLD_SIZE  # whole 16-byte vectors
    assert t.crc_fold_tables_np().shape == (t.FOLD_SIZE,)


def test_crc_rejects_width_mismatch():
    from x3_tpu_torch.ops.crc_torch import crc16_words

    with pytest.raises(ValueError):
        crc16_words(torch.zeros((2, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 5)


@pytest.mark.parametrize("length", ["zero", "one", "odd", "full"])
@pytest.mark.parametrize("n_bytes", [1, 3, 4, 5, 131])
def test_crc16_padded_matches_jax(n_bytes, length):
    """crc16_padded against crc16_padded_jax and crc16_many on the same
    zero-padded byte rows."""
    import jax.numpy as jnp

    from x3_tpu.ops.crc_jax import crc16_padded_jax

    from x3_tpu_torch.ops.crc_torch import crc16_padded

    n = {"zero": 0, "one": 1, "odd": n_bytes - 1 + n_bytes % 2, "full": n_bytes}[length]
    rng = np.random.default_rng(100 * n_bytes + n)
    rows = rng.integers(0, 256, (5, n_bytes), dtype=np.uint8)
    lengths = np.full(5, n, np.int32)
    rows[:, n:] = 0
    got = crc16_padded(torch.from_numpy(rows), torch.from_numpy(lengths), n_bytes)
    assert got.dtype == torch.int32
    want = np.asarray(crc16_padded_jax(jnp.asarray(rows), jnp.asarray(lengths), n_bytes))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), crc16_many(rows, lengths))
