"""x3_tpu_torch's encode_frames (plain version of kernel K2 plus the CRC)
against x3_tpu's encode_frames(pack_mode="block") at every width rung,
including overflowing ones, and against the fused Pallas encode kernel in
interpret mode.  Exact (tolerance 0)."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import x3_tpu_torch as xt
from tests.conftest import make_hydrophone, make_mixed
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)  # 32 samples/frame, W=24, NW=4


def port_params(p: Parameters) -> xt.Parameters:
    """The port's Parameters with the same fields as the JAX package's."""
    return xt.Parameters(**dataclasses.asdict(p))


def _frames(rng, params, F):
    spf = params.samples_per_frame
    frames = make_mixed(rng, F * spf).reshape(F, spf).astype(np.int16)
    n_valid = np.full(F, spf, np.int32)
    n_valid[-1] = spf - 2  # partial frame
    n_valid[-2] = 1  # single-sample frame
    n_valid[-3] = 0  # dummy frame
    frames[-3] = 0
    frames[-1, spf - 2 :] = 0
    frames[-2, 1:] = 0
    return frames, n_valid


def _jax(frames, n_valid, params, w, nw):
    import jax.numpy as jnp

    from x3_tpu.ops.encode_kernel import encode_frames

    out = encode_frames(jnp.asarray(frames), jnp.asarray(n_valid), params, "block", w, nw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port(frames, n_valid, params, w, nw):
    from x3_tpu_torch.ops.encode_kernel import encode_frames

    out = encode_frames(torch.from_numpy(frames), torch.from_numpy(n_valid), port_params(params),
                        "block", w, nw)
    return {k: v.numpy() for k, v in out.items()}


def _assert_contract(got, want, params, w, nw):
    """Counts exact on every frame; words and CRC exact on frames that fit
    both rungs (the others are truncated, as the contract allows)."""
    from x3_tpu.ops.encode_kernel import block_buffer_words, frame_geometry

    for key in ("nbytes", "total_bits", "stats", "blockfit_bits"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    WF = frame_geometry(params)[3]
    fits = (want["nbytes"] <= (min(w, WF) - 2) * 4) | (w >= WF)
    fits &= (want["blockfit_bits"] <= (nw + 7) * 32) | (nw >= block_buffer_words(params))
    words = got["payload_words"].view(np.uint32)
    np.testing.assert_array_equal(words[fits], want["payload_words"][fits])
    np.testing.assert_array_equal(got["crc"][fits], want["crc"][fits])
    return fits


@pytest.mark.parametrize("w,nw", list(itertools.product([6, 8, 12, 24], [2, 3, 4])))
def test_encode_matches_jax_at_every_rung(w, nw):
    rng = np.random.default_rng(100 + w * 10 + nw)
    frames, n_valid = _frames(rng, TINY, 11)
    got = _port(frames, n_valid, TINY, w, nw)
    want = _jax(frames, n_valid, TINY, w, nw)
    fits = _assert_contract(got, want, TINY, w, nw)
    assert fits.sum() >= 3  # dummy, single-sample and partial frames always fit
    if w < 12:
        assert not fits.all(), "the compact rung must overflow some frames"


def test_encode_words_exact_at_full_width(rng):
    """At the full rungs every frame's words equal JAX's, and int32 samples
    encode like int16 ones."""
    frames, n_valid = _frames(rng, TINY, 23)
    want = _jax(frames, n_valid, TINY, None, None)
    got = _port(frames, n_valid, TINY, None, None)
    assert _assert_contract(got, want, TINY, 24, 4).all()
    got32 = _port(frames.astype(np.int32), n_valid, TINY, None, None)
    for k in got:
        np.testing.assert_array_equal(got32[k], got[k])


@pytest.mark.parametrize("W", [24, 8])
def test_encode_matches_fused_pallas_interpret(rng, W):
    import jax.numpy as jnp

    from x3_tpu.ops.encode_fused_pallas import encode_frames_fused_words

    from x3_tpu_torch.ops.encode_kernel import encode_words_plain

    frames, n_valid = _frames(rng, TINY, 11)
    words, total_bits, blockfit, stats = encode_frames_fused_words(
        jnp.asarray(frames), jnp.asarray(n_valid), TINY, W, True, (3, 256, 2, "dyn")
    )
    pw, ptb, pbf, pnb, pst = encode_words_plain(
        torch.from_numpy(frames), torch.from_numpy(n_valid), port_params(TINY), W
    )
    np.testing.assert_array_equal(ptb.numpy(), np.asarray(total_bits))
    np.testing.assert_array_equal(pbf.numpy(), np.asarray(blockfit))
    np.testing.assert_array_equal(pst.numpy(), np.asarray(stats))
    nb = (np.asarray(total_bits) + 7) // 8
    np.testing.assert_array_equal(pnb.numpy(), nb + (nb & 1))
    fits = pnb.numpy() <= (W - 2) * 4
    np.testing.assert_array_equal(pw.numpy().view(np.uint32)[fits], np.asarray(words)[fits])


@pytest.mark.parametrize("w,nw", [(2048, 6), (512, 4), (None, None)])
def test_encode_default_geometry(w, nw):
    """Parameters() (10,000-sample frames) on four frames: a hydrophone-like
    frame, a mixed frame, a partial frame and a single-sample frame."""
    params = Parameters()
    spf = params.samples_per_frame
    rng = np.random.default_rng(7)
    frames = np.stack(
        [make_hydrophone(rng, spf), make_mixed(rng, spf), make_hydrophone(rng, spf), np.zeros(spf)]
    ).astype(np.int16)
    n_valid = np.asarray([spf, spf, 4321, 1], np.int32)
    frames[2, 4321:] = 0
    frames[3, 0] = -1234
    got = _port(frames, n_valid, params, w, nw)
    want = _jax(frames, n_valid, params, w, nw)
    fits = _assert_contract(got, want, params, w or 10**9, nw or 10**9)
    assert fits[3] and fits[0] == (w != 512)  # the 512-word rung overflows full frames


# ---- kernel K2's decomposition (csrc/encode.cu), modelled in numpy -------

_UNSTAGED = 1 << 20  # a staging slot the kernel never wrote


def _stage(row, lo, hi, size, addr):
    """stage_chunk: samples lo..hi (inclusive; sample S reads as 0) at slot
    j - lo + pad of a `size`-slot buffer, for a row at byte address `addr`.
    Checks the 16-byte vector body is aligned on both sides."""
    from x3_tpu_torch.ops.encode_cuda import STAGE_PAD

    S = len(row)
    st = np.full(size, _UNSTAGED, np.int64)
    pad = (addr + 2 * lo) % 16 // 2
    cnt = min(hi, S - 1) - lo + 1
    if cnt > 0:
        head = min((8 - pad) % 8, cnt)
        if (cnt - head) // 8:
            assert (addr + 2 * (lo + head)) % 16 == 0 and 2 * (pad + head) % 16 == 0
        st[pad : pad + cnt] = row[lo : lo + cnt]  # head, 16-byte vectors, tail
    if hi == S:
        st[pad + S - lo] = 0
    assert pad < STAGE_PAD and pad + max(hi - lo, 0) < size
    return st, pad


def _k2_model(frames, n_valid, params, W, addr=0):
    """csrc/encode.cu's arithmetic in numpy, every frame (CTA) at once over
    lanes [F, T]: chunks of whole blocks staged (or read from the row when
    none fits), one sweep per block for its max |diff| and the sums that
    give Rice bits in closed form, the warp scan with the offset carried
    from chunk to chunk, then every block
    through a 64-bit accumulator, two samples a step (one put where both
    codes fit 32 bits), into word-owning stores, boundary words ORed,
    truncated at W.  Checks that the emitted bits end where the scan
    says, that no slot is read unstaged, and that a plainly stored word
    gets no other write.  `addr` is the byte address of frame 0's row."""
    from x3_tpu_torch.ops.encode_cuda import STAGE_PAD, chunk_blocks

    F, S = frames.shape
    B, L = params.blocks_per_frame, params.block_len
    t0, t1, t2 = params.thresholds
    ords = np.asarray(params.codes, np.int64)
    rslots = np.asarray([rc.nsubs for rc in params.rice_codes], np.int64)
    T, CH = chunk_blocks(B, L, W)
    staged, CH = CH > 0, CH or T
    rows = frames.astype(np.int64)
    n = n_valid.astype(np.int64)[:, None]
    last = np.minimum(n[:, 0] - 1, S)
    lane = np.arange(T)[None, :]
    fidx = np.arange(F)[:, None]
    M32, U = np.uint64(0xFFFFFFFF), np.uint64
    sw = np.zeros(F * W, np.uint64)
    writes = np.zeros(F * W, np.int64)
    plain = np.zeros(F * W, bool)
    carry = np.zeros((F, 1), np.int64)
    stats = np.zeros((F, 6), np.int64)
    fit = np.zeros(F, np.int64)

    for cb0 in range(0, B, CH):
        lo = cb0 * L
        if staged:
            bufs = [_stage(rows[f], lo, min(lo + CH * L, int(last[f])), CH * L + STAGE_PAD, addr + 2 * f * S)
                    for f in range(F)]
            st = np.stack([b for b, _ in bufs])
            sh = np.asarray([p for _, p in bufs])[:, None] - lo

        def at(j, m):
            if staged:
                v = st[fidx, np.where(m, j + sh, 0)]
                assert (v[m] != _UNSTAGED).all(), "read a slot the staging did not write"
            else:
                v = rows[fidx, np.clip(j, 0, S - 1)]
                v = np.where(j < S, v, 0)
            return np.where(m, v, 0)

        # Step 2: descriptors and bits, one lane per block.
        b = cb0 + lane
        mine = (lane < CH) & (b < B)
        base = b * L
        cnt = np.where(mine, np.clip(n - 1 - base, 0, L), 0)
        ma, se, neg, se1, se2 = (np.zeros((F, T), np.int64) for _ in range(5))
        prev = at(base, cnt > 0)
        for k in range(1, L + 1):
            m = k <= cnt
            d = np.where(m, at(base + k, m) - prev, 0)
            e = np.where(d >= 0, d, -d - 1)
            ma, se, neg = np.maximum(ma, np.abs(d)), se + e, neg + (d < 0)
            se1, se2 = se1 + (e >> 1), se2 + (e >> 2)
            prev = np.where(m, prev + d, prev)
        ftype = (ma > t0).astype(np.int64) + (ma > t1) + (ma > t2)
        rsel = np.minimum(ftype, 2)
        nb = np.floor(np.log2(np.maximum(ma, 1))).astype(np.int64) + 1
        kind = np.where(ma <= t2, 0, np.where(nb >= 15, 2, 1))  # Rice, BFP, literal
        order = ords[rsel]
        hdr_len = np.where(cnt > 0, np.where(kind == 0, 2, 6), 0)
        hdr_val = np.where(kind == 0, ftype + 1, np.where(kind == 2, 15, nb))
        first = mine & (b == 0) & (n > 0)
        rice_bits = np.where(order == 0, 2 * se + cnt + neg,
                             (order + 1) * cnt + np.choose(np.clip(order - 1, 0, 2), [se, se1, se2]))
        bits = np.where(first, 16, 0) + hdr_len + np.where(kind == 0, rice_bits,
                                                           cnt * np.where(kind == 2, 16, nb + 1))

        # Step 3: warp-shuffle scan, then the warp totals.
        incl = np.cumsum(bits.reshape(F, -1, 32), axis=2)
        wsum = incl[:, :, -1]
        before = np.repeat(np.cumsum(wsum, axis=1) - wsum, 32, axis=1)
        start = carry + before + incl.reshape(F, T) - bits
        carry = carry + wsum.sum(axis=1, keepdims=True)

        # Step 4: the emitter, every lane at once.
        act = mine & (bits > 0) & (start < 32 * W)
        acc = np.zeros((F, T), np.uint64)
        na = start & 31
        w = start >> 5
        head = na != 0

        def store(m, word, shared):
            idx = (fidx * W + w)[m]
            np.add.at(writes, idx, 1)
            np.bitwise_or.at(sw, idx[shared[m]], word[m][shared[m]])
            sw[idx[~shared[m]]] = word[m][~shared[m]]
            plain[idx[~shared[m]]] = True

        def flush(m):
            nonlocal acc, na, w, head
            m = m & (na >= 32)
            na = np.where(m, na - 32, na)
            word = (acc >> U(0) + na.astype(U)) & M32
            store(m & (w < W), word, head)
            head = np.where(m, False, head)
            w = np.where(m, w + 1, w)

        def put(v, ln, m):
            nonlocal acc, na
            m = m & act
            while (m & (ln > 32)).any():
                lng = m & (ln > 32)
                z = np.minimum(ln - 32, 32)
                acc = np.where(lng, acc << np.where(lng, z, 0).astype(U), acc)
                na = np.where(lng, na + z, na)
                flush(lng)
                ln = np.where(lng, ln - z, ln)
            acc = np.where(m, (acc << np.where(m, ln, 0).astype(U)) | v.astype(U), acc)
            na = np.where(m, na + ln, na)
            flush(m)

        def code(d, cur):
            e = np.where(d >= 0, d, -d - 1)
            km1 = np.maximum(order - 1, 0)
            low = (d & ((1 << km1) - 1)) << 1
            rv = np.where(d >= 0, (1 << order) | low, ((1 << (order + 1)) - 1) - low)
            rl = np.where(order == 0, 2 * e + 1 + (d < 0), order + 1 + (e >> km1))
            v = np.where(kind == 0, rv, np.where(kind == 2, cur & 0xFFFF, d & ((1 << (nb + 1)) - 1)))
            return v, np.where(kind == 0, rl, np.where(kind == 2, 16, nb + 1))

        put(at(np.zeros_like(base), first) & 0xFFFF, np.full((F, T), 16), first)
        put(hdr_val, hdr_len, cnt > 0)
        prev = at(base, cnt > 0)
        for k in range(1, L + 1, 2):  # two samples a step: one put when both fit 32 bits
            m1, m2 = k + 1 <= cnt, k == cnt
            c1, c2 = at(base + k, m1 | m2), at(base + k + 1, m1)
            (v1, l1), (v2, l2) = code(c1 - prev, c1), code(c2 - c1, c2)
            one = m1 & (l1 + l2 <= 32)
            put(np.where(one, (v1 << np.where(one, l2, 0)) | v2, 0), l1 + l2, one)
            put(np.where(m1 | m2, v1, 0), l1, (m1 & ~one) | m2)
            put(np.where(m1, v2, 0), l2, m1 & ~one)
            prev = np.where(m1, c2, np.where(m2, c1, prev))
        assert (32 * w + na == start + bits)[act].all(), "the emitted bits end where the scan says"
        tail = act & (na > 0) & (w < W)
        store(tail, (acc << (U(32) - na.astype(U))) & M32, np.ones_like(tail))

        slot = np.where(kind == 0, rslots[rsel], np.where(kind == 2, 5, 4))
        for s in range(6):
            stats[:, s] += np.where(slot == s, cnt, 0).sum(axis=1)
        fit = np.maximum(fit, np.where(mine, (start & 255) + bits, 0).max(axis=1))

    assert (writes[plain] == 1).all(), "a plainly stored word was written twice"
    total = carry[:, 0]
    nb8 = (total + 7) // 8
    return sw.astype(np.uint32).reshape(F, W), total, fit, nb8 + (nb8 & 1), stats


def _edge_frames(rng, params, F):
    """Frames each of every class (silence, small, medium and BFP-sized
    noise, full-scale noise for literal blocks, a random walk), one wholly
    full-scale noise frame, and the n_valid edges 0, 1, 2, L, L+1, S-1, S."""
    from x3_tpu_torch.ops.encode_kernel import frame_geometry

    S, _, L, _ = frame_geometry(port_params(params))
    frames = np.stack([make_mixed(rng, S) for _ in range(F)]).astype(np.int16)
    frames[1] = rng.integers(-32768, 32768, S)
    edges = [0, 1, 2, L, L + 1, S - 1, S]
    n_valid = np.full(F, S, np.int32)
    n_valid[-len(edges):] = np.minimum(edges, S)
    for f in range(F):
        frames[f, n_valid[f]:] = 0
    return frames, n_valid


K2_MODEL_GEOMETRIES = {
    "L4B8": TINY, "L30B3": Parameters(block_len=30, blocks_per_frame=3),
    "L7B40": Parameters(block_len=7, blocks_per_frame=40), "L7B41": Parameters(block_len=7, blocks_per_frame=41),
    "default": Parameters(),
    # Rice blocks with |diff| up to about 2,000: items of up to 504 bits.
    "L7B41-t2000": Parameters(block_len=7, blocks_per_frame=41, thresholds=(3, 8, 2000)),
}


@pytest.mark.parametrize("addr", [0, 6])
@pytest.mark.parametrize("geometry", list(K2_MODEL_GEOMETRIES))
def test_k2_model_matches_encode_words_plain(geometry, addr):
    """The kernel's decomposition equals the plain version bit for bit at
    the fitting, full and overflowing compact rungs and at W = 1 and 8, on
    rows whose 16-byte alignment varies from frame to frame."""
    from x3_tpu_torch.ops.encode_kernel import encode_words_plain, frame_geometry, fits_width, width_rungs

    params = K2_MODEL_GEOMETRIES[geometry]
    pp = port_params(params)
    rng = np.random.default_rng(31 + addr + params.block_len)
    frames, n_valid = _edge_frames(rng, params, 9 if geometry == "default" else 12)
    _, _, _, WF = frame_geometry(pp)
    st, nv = torch.from_numpy(frames), torch.from_numpy(n_valid)
    nbytes = encode_words_plain(st, nv, pp, WF)[3].numpy()
    w_fit = next(r for r in width_rungs(pp) if fits_width(nbytes, r, pp))
    for W in sorted({1, 8, w_fit, WF, max(8, w_fit // 2)}):
        want = [x.numpy() for x in encode_words_plain(st, nv, pp, W)]
        got = _k2_model(frames, n_valid, params, W, addr)
        np.testing.assert_array_equal(got[0], want[0].view(np.uint32), err_msg=f"words W={W}")
        for name, g, w in zip(("total_bits", "blockfit", "nbytes", "stats"), got[1:], want[1:]):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} W={W}")


@pytest.mark.parametrize("params,W", [
    (Parameters(block_len=6200, blocks_per_frame=2), None),  # a block longer than the staging buffer
    (Parameters(block_len=1000, blocks_per_frame=3), 57000),  # words leave room for two blocks a chunk
    (Parameters(block_len=30, blocks_per_frame=3), "max"),  # words leave no room: device-memory reads
], ids=["L6200B2", "L1000B3-W57000", "L30B3-Wmax"])
def test_k2_model_without_a_full_chunk(params, W):
    """Where the staging buffer holds fewer blocks than threads, or none,
    the model (chunks of what fits, or reads from the row) still equals
    the plain version."""
    from x3_tpu_torch.ops.encode_cuda import MAX_WORDS, chunk_blocks
    from x3_tpu_torch.ops.encode_kernel import encode_words_plain, frame_geometry

    pp = port_params(params)
    W = {None: frame_geometry(pp)[3], "max": MAX_WORDS}.get(W, W)
    T, CH = chunk_blocks(params.blocks_per_frame, params.block_len, W)
    assert CH < T
    frames, n_valid = _edge_frames(np.random.default_rng(41), params, 8)
    want = [x.numpy() for x in encode_words_plain(torch.from_numpy(frames), torch.from_numpy(n_valid), pp, W)]
    got = _k2_model(frames, n_valid, params, W)
    np.testing.assert_array_equal(got[0], want[0].view(np.uint32))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_k2_layout_matches_the_kernel():
    """csrc/encode.cu's shared-memory and chunk constants are encode_cuda's,
    and the launch geometry of the main path is one chunk of 256 blocks
    then one of 244, staged, at every width rung."""
    import re
    from pathlib import Path

    from x3_tpu_torch.ops import encode_cuda as ec
    from x3_tpu_torch.ops.encode_kernel import frame_geometry, width_rungs

    src = (Path(ec.__file__).parent.parent / "csrc" / "encode.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int k(Threads|SmemBytes|StaticBytes|StageBytes|Pad) = (\d+);",
                                            src)}
    assert got == {"Threads": ec.THREADS, "SmemBytes": ec.SMEM_BYTES, "StaticBytes": ec.STATIC_BYTES,
                   "StageBytes": ec.STAGE_BYTES, "Pad": ec.STAGE_PAD}
    assert "kMaxWords = (kSmemBytes - kStaticBytes) / 16 * 4;" in src
    assert ec.MAX_WORDS == 58080 and ec.MAX_WORDS % 4 == 0
    # The parent's limit: its 1,052 static bytes plus 4 W had to fit 227 KB.
    assert ec.MAX_WORDS >= (ec.SMEM_BYTES - 1052) // 4
    p = xt.Parameters()
    for W in width_rungs(p):
        assert ec.chunk_blocks(p.blocks_per_frame, p.block_len, W) == (256, 256), W
    assert frame_geometry(p)[3] == 5096
    assert ec.chunk_blocks(41, 7, 8) == (64, 64)
    assert ec.chunk_blocks(3, 30, ec.MAX_WORDS) == (32, 0)
