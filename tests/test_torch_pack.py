"""The port's encode pack routes against x3_tpu's: the plain versions of
kernels K4 (front), K5 (block pack) and K6 (pack walk) against the Pallas
kernels in interpret mode, `_merge` against `_merge_mxu`, and
encode_frames in every pack_mode and every route of "block" against JAX
encode_frames.  Exact (integers, tolerance 0)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import x3_tpu_torch as xt
from chip_smoke import K6_EDGES
from tests.conftest import make_mixed
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)  # 32 samples/frame, W=24, NW=4
ODD = Parameters(block_len=5, blocks_per_frame=6, codes=(1, 2, 3), thresholds=(8, 20, 40))
ROUTES = {  # port route -> (pack_mode, environment)
    "block-K2": ("block", {"X3_FUSED_ENCODE": "1"}),
    "block-pairs": ("block", {"X3_FUSED_ENCODE": "0", "X3_PALLAS_PACK": "0"}),
    "block-K6": ("block", {"X3_FUSED_ENCODE": "0", "X3_PALLAS_PACK": "1"}),
    "block_pallas": ("block_pallas", {}),
    "fused_pallas": ("fused_pallas", {}),
    "segment": ("segment", {}),
}
EXACT_ROUTES = ("block-pairs", "block_pallas", "fused_pallas")  # every word, overflow too


def port_params(p: Parameters) -> xt.Parameters:
    return xt.Parameters(**dataclasses.asdict(p))


def _frames(rng, params, F):
    """Mixed frames with a partial, a one-sample and a dummy frame."""
    spf = params.samples_per_frame
    frames = make_mixed(rng, F * spf).reshape(F, spf).astype(np.int16)
    n_valid = np.full(F, spf, np.int32)
    n_valid[-1], n_valid[-2], n_valid[-3] = spf - 3, 1, 0
    frames[-1, spf - 3 :] = 0
    frames[-2, 1:] = 0
    frames[-3] = 0
    return frames, n_valid


def _with_env(env, fn):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _port(frames, n_valid, params, route, w, nw):
    from x3_tpu_torch.ops.encode_kernel import encode_frames

    mode, env = ROUTES[route]
    out = _with_env(env, lambda: encode_frames(torch.from_numpy(frames), torch.from_numpy(n_valid),
                                               port_params(params), mode, w, nw))
    return {k: v.numpy() for k, v in out.items()}


def _jax(frames, n_valid, params, mode, w, nw):
    """JAX encode_frames; the Pallas modes run their kernels in interpret
    mode with 16-lane tiles (as tests/test_jax_encode.py does)."""
    import jax.numpy as jnp

    from x3_tpu.ops import front_pallas, pack_pallas
    from x3_tpu.ops.encode_kernel import encode_frames

    of, op = front_pallas.encode_front_pallas, pack_pallas.pack_blocks_pallas
    tiles = (front_pallas.LANE_TILE, pack_pallas.LANE_TILE)
    front_pallas.LANE_TILE = pack_pallas.LANE_TILE = 16
    front_pallas.encode_front_pallas = lambda *a: of(*a[:7], True)
    pack_pallas.pack_blocks_pallas = lambda iv, il, rr, nb4, i: op(iv, il, rr, nb4, True)
    try:
        out = encode_frames(jnp.asarray(frames), jnp.asarray(n_valid), params, mode, w, nw)
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        front_pallas.LANE_TILE, pack_pallas.LANE_TILE = tiles
        front_pallas.encode_front_pallas, pack_pallas.pack_blocks_pallas = of, op


def _exact_words(frames, n_valid, params, w, nw):
    """Per frame, the leading words every route must agree on: all W when
    the frame fits both rungs; else the words before the first block that
    overflows the NW rung, and before word W-1 when the frame overflows W."""
    from x3_tpu_torch.ops.encode_kernel import _items, block_buffer_words, frame_geometry

    _, item_len, _ = _items(torch.from_numpy(frames), torch.from_numpy(n_valid), port_params(params))
    bb = item_len.sum(dim=2).numpy()
    be = np.cumsum(bb, axis=1)
    boff = be - bb
    WF = frame_geometry(port_params(params))[3]
    W = min(w or WF, WF)
    nw = nw or block_buffer_words(port_params(params))
    bad = ((boff & 255) + bb > (nw + 7) * 32) & (nw < block_buffer_words(port_params(params)))
    safe = np.where(bad.any(axis=1), boff[np.arange(len(bb)), bad.argmax(axis=1)] >> 5, W)
    nb = (be[:, -1] + 7) // 8
    over_w = (nb + (nb & 1) > (W - 2) * 4) & (W < WF)
    return np.minimum(safe, np.where(over_w, W - 1, W)), W


def _assert_route(got, want, frames, n_valid, params, route, w, nw):
    keys = ["nbytes", "total_bits", "stats"] + ([] if route == "segment" else ["blockfit_bits"])
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    safe, W = _exact_words(frames, n_valid, params, w, nw)
    fits = safe == W
    words = got["payload_words"].view(np.uint32)
    np.testing.assert_array_equal(got["crc"][fits], want["crc"][fits], err_msg="crc")
    if route in EXACT_ROUTES:
        np.testing.assert_array_equal(words, want["payload_words"], err_msg="words")
    for f in range(len(words)):
        np.testing.assert_array_equal(words[f, : safe[f]], want["payload_words"][f, : safe[f]],
                                      err_msg=f"words of frame {f}")
    return fits


@pytest.mark.parametrize("w,nw", [(None, None), (8, 2), (12, 3)], ids=["fit", "over-w8-nw2", "over-w12-nw3"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_frames_route_matches_jax(route, w, nw):
    """Each route against JAX encode_frames in the same pack_mode (JAX
    "block" for every route of "block"; on the CPU it is the XLA pair
    pack) at TINY, at the full rungs and at W and NW rungs that overflow."""
    rng = np.random.default_rng(40 + (w or 0) + (nw or 0))
    frames, n_valid = _frames(rng, TINY, 11)
    mode = ROUTES[route][0]
    got = _port(frames, n_valid, TINY, route, w, nw)
    want = _jax(frames, n_valid, TINY, mode, w, nw)
    fits = _assert_route(got, want, frames, n_valid, TINY, route, w, nw)
    assert fits.sum() >= 3  # dummy, one-sample and partial frames fit any rung
    if w is not None:
        assert not fits.all(), "the compact rungs must overflow some frames"


@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_frames_route_default_geometry(route):
    """Parameters() on four make_mixed frames (one partial, one of one
    sample): every route equals JAX "block" (XLA) at the full rungs."""
    params = Parameters()
    spf = params.samples_per_frame
    rng = np.random.default_rng(9)
    frames = make_mixed(rng, 4 * spf).reshape(4, spf).astype(np.int16)
    n_valid = np.asarray([spf, spf, 4321, 1], np.int32)
    frames[2, 4321:] = 0
    frames[3, 1:] = 0
    got = _port(frames, n_valid, params, route, None, None)
    want = _jax(frames, n_valid, params, "block", None, None)
    for k in want:
        if k == "blockfit_bits" and route == "segment":
            assert not got[k].any()
            continue
        g = got[k].view(np.uint32) if k == "payload_words" else got[k]
        np.testing.assert_array_equal(g, want[k], err_msg=k)


def _lanes_np(frames, n_valid, L, B):
    """The fused route's lane inputs (x3_tpu.ops.encode_kernel.
    _encode_frames_fused): sblk [L, N], sprev, first_val, nv_lane [1, N]."""
    F = len(frames)
    s = frames.astype(np.int32)
    snext = np.concatenate([s[:, 1:], np.zeros((F, 1), np.int32)], axis=1)
    sblk = np.ascontiguousarray(np.moveaxis(snext.reshape(F, B, L), 2, 0).reshape(L, F * B))
    sprev = s[:, ::L][:, :B].reshape(1, -1)
    b = np.arange(B)[None, :]
    n = n_valid[:, None]
    first = np.where((b == 0) & (n > 0), s[:, :1] & 0xFFFF, -1).reshape(1, -1).astype(np.int32)
    nv = np.clip(n - 1 - b * L, 0, L).reshape(1, -1).astype(np.int32)
    return sblk, np.ascontiguousarray(sprev), first, nv


def _pad_lanes(x, fill=0, tile=16):
    pad = (-x.shape[1]) % tile
    return np.pad(x, ((0, 0), (0, pad)), constant_values=fill)


@pytest.mark.parametrize("params", [TINY, ODD], ids=["tiny", "odd-codes"])
def test_front_plain_matches_pallas_interpret(params):
    import jax.numpy as jnp

    from x3_tpu.ops import front_pallas

    from x3_tpu_torch.ops.front_cuda import encode_front_plain

    rng = np.random.default_rng(21)
    frames, n_valid = _frames(rng, params, 9)
    frames[0, 3] = -32768  # a full-scale jump: a literal block
    sblk, sprev, first, nv = _lanes_np(frames, n_valid, params.block_len, params.blocks_per_frame)
    N = sblk.shape[1]
    t = torch.from_numpy
    got = encode_front_plain(t(sblk), t(sprev), t(first), t(nv), port_params(params))
    orig = front_pallas.LANE_TILE
    front_pallas.LANE_TILE = 16
    try:
        want = front_pallas.encode_front_pallas(
            jnp.asarray(_pad_lanes(sblk)), jnp.asarray(_pad_lanes(sprev)),
            jnp.asarray(_pad_lanes(first, -1)), jnp.asarray(_pad_lanes(nv)),
            params.block_len, params.codes, params.thresholds, True)
    finally:
        front_pallas.LANE_TILE = orig
    for g, w, name in zip(got, want, ("item_val", "item_len", "slot")):
        g = g.numpy().view(np.uint32) if name == "item_val" else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w)[:, :N], err_msg=name)
    assert set(np.asarray(want[2])[0, :N].tolist()) >= {4, 5}  # BFP and literal blocks present


@pytest.mark.parametrize("nw", [4, 2, 1], ids=["nw4-full", "nw2", "nw1-overflow"])
def test_pack_blocks_plain_matches_pallas_interpret(nw):
    import jax.numpy as jnp

    from x3_tpu.ops import pack_pallas

    from x3_tpu_torch.ops.encode_kernel import _items, _lanes
    from x3_tpu_torch.ops.pack_cuda import pack_blocks_plain
    from x3_tpu_torch.ops._bits import as_i32

    rng = np.random.default_rng(22 + nw)
    frames, n_valid = _frames(rng, TINY, 10)
    iv, il, _ = _items(torch.from_numpy(frames), torch.from_numpy(n_valid), port_params(TINY))
    F, B, _ = iv.shape
    bb = il.sum(dim=2)
    r2 = ((bb.cumsum(dim=1) - bb) & 255).reshape(1, F * B).to(torch.int32)
    vals, lens = _lanes(as_i32(iv)), _lanes(il)
    nb4 = nw + 7
    got = pack_blocks_plain(vals, lens, r2, nb4).numpy().view(np.uint32)
    orig = pack_pallas.LANE_TILE
    pack_pallas.LANE_TILE = 16
    try:
        want = pack_pallas.pack_blocks_pallas(
            jnp.asarray(_pad_lanes(vals.numpy().view(np.uint32))), jnp.asarray(_pad_lanes(lens.numpy())),
            jnp.asarray(_pad_lanes(r2.numpy())), nb4, True)
    finally:
        pack_pallas.LANE_TILE = orig
    np.testing.assert_array_equal(got, np.asarray(want)[:, : F * B])
    if nw == 1:
        assert ((r2.numpy()[0] + bb.reshape(-1).numpy()) > nb4 * 32).any(), "must overflow"


def _pairs_with_offsets(mlen):
    be = np.cumsum(mlen.sum(axis=2), axis=1)
    return (be - mlen.sum(axis=2)).astype(np.int32), be


def _random_pairs(rng, F, B, P, NB):
    """Well-formed pairs (val < 2^len) whose blocks span <= NB words from
    any in-word offset (tests/test_pack_walk.py)."""
    maxbits = NB * 32 - 31
    mlen = rng.integers(0, 33, (F, B, P)).astype(np.int32)
    mlen = (mlen // np.maximum(1, mlen.sum(axis=2, keepdims=True) // maxbits + 1)).astype(np.int32)
    mlen[:, B // 2 :, :] = np.where(rng.random((F, B - B // 2, P)) < 0.3, 0, mlen[:, B // 2 :, :])
    mval = (rng.integers(0, 2**32, (F, B, P), dtype=np.uint64)
            & ((1 << mlen.astype(np.uint64)) - 1)).astype(np.uint32)
    return mval, mlen


def _walk_port(mval, mlen, boff, W, L):
    from x3_tpu_torch.ops.pack_walk_cuda import pack_walk_plain

    t = torch.from_numpy
    return pack_walk_plain(t(mval.view(np.int32)), t(mlen), t(boff), W, L).numpy().view(np.uint32)


def _walk_jax(mval, mlen, boff, W, L, geo):
    import jax.numpy as jnp

    from x3_tpu.ops.pack_walk_pallas import pack_frames_walk

    return np.asarray(pack_frames_walk(jnp.asarray(mval), jnp.asarray(mlen), jnp.asarray(boff),
                                       W, L, True, geo))


@pytest.mark.parametrize("case", ["fit", "overflow"])
def test_pack_walk_plain_matches_pallas_interpret(case):
    """K6's plain version against pack_frames_walk in interpret mode with
    the geometry overrides of tests/test_pack_walk.py: every word when the
    frames fit, the words before the first overflowing block when they
    overflow W; and against the port's own pair pack."""
    from x3_tpu_torch.ops.encode_kernel import _pack_pairs

    rng = np.random.default_rng(31 if case == "fit" else 32)
    geo = (2, 256, 2, 3)  # U, TF, K, NB: several steps and windows
    F, B, P, L = (3, 8, 3, 4) if case == "fit" else (2, 12, 3, 4)
    W = 16 if case == "fit" else 4
    mval, mlen = _random_pairs(rng, F, B, P, geo[3])
    if case == "overflow":
        mlen = np.maximum(mlen, 8).astype(np.int32)
        mval = (mval & ((1 << mlen.astype(np.uint64)) - 1)).astype(np.uint32)
    boff, be = _pairs_with_offsets(mlen)
    got = _walk_port(mval, mlen, boff, W, L)
    want = _walk_jax(mval, mlen, boff, W, L, geo)
    pairs = _pack_pairs(torch.from_numpy(mval.astype(np.int64)), torch.from_numpy(mlen).to(torch.int64),
                        W, 12)[0].numpy()
    if case == "fit":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pairs)
    else:
        for f in range(F):
            over = be[f] > W * 32
            assert over.any()
            safe = max(0, int(boff[f, np.argmax(over)]) // 32 - 1)
            np.testing.assert_array_equal(got[f, :safe], want[f, :safe])
            np.testing.assert_array_equal(got[f, :safe], pairs[f, :safe])


def test_pack_walk_full_literal_block_at_word_tail():
    """A 326-bit literal block (6-bit header + 20 16-bit samples) starting
    at in-word offset 27 spans 12 words: NB at L=20 covers it."""
    from x3_tpu.ops.pack_walk_pallas import _pack_geometry

    from x3_tpu_torch.ops.pack_walk_cuda import walk_buffer_words

    F, B, P, L, W = 2, 2, 11, 20, 32
    NB = walk_buffer_words(L)
    assert NB == _pack_geometry(2048, 500, L, P, 768)[3] == 12
    mval = np.zeros((F, B, P), np.uint32)
    mlen = np.zeros((F, B, P), np.int32)
    mlen[:, 0, 0], mval[:, 0, 0] = 27, 0x501_FACE
    mlen[:, 1, 0], mval[:, 1, 0] = 6, 0x2F
    mlen[:, 1, 1:] = 32
    mval[:, 1, 1:] = np.arange(1, 11, dtype=np.uint32)[None, :] * 0x0F0F_0F0F
    mval[:, 1, -1] |= 1  # the block's last bit, in its 12th word
    boff, _ = _pairs_with_offsets(mlen)
    got = _walk_port(mval, mlen, boff, W, L)
    np.testing.assert_array_equal(got, _walk_jax(mval, mlen, boff, W, L, (2, 256, 3, NB)))
    assert got[:, 11].any()  # the block's 12th word


@pytest.mark.parametrize("w,nw", [(24, 4), (12, 3), (8, 2), (6, 4)])
def test_merge_matches_merge_mxu(w, nw):
    """`_merge` against `_merge_mxu` on every word, on the block buffers
    of real frames (`_pack_pairs`' level 1), overflowing frames included."""
    import jax.numpy as jnp

    from x3_tpu.ops.encode_kernel import _merge_mxu

    from x3_tpu_torch.ops._bits import bit_pieces
    from x3_tpu_torch.ops.encode_kernel import _items, _merge, _pairs

    rng = np.random.default_rng(50 + w + nw)
    frames, n_valid = _frames(rng, TINY, 12)
    iv, il, _ = _items(torch.from_numpy(frames), torch.from_numpy(n_valid), port_params(TINY))
    mval, mlen = _pairs(iv, il)
    F, B, _ = mval.shape
    NB4 = nw + 7
    ends = mlen.cumsum(dim=2)
    bb = ends[:, :, -1]
    boff = bb.cumsum(dim=1) - bb
    mpoff = ends - mlen + (boff & 255)[:, :, None]
    hi, lo = bit_pieces(mval, mlen, mpoff)
    t = mpoff >> 5
    buf = torch.zeros((F, B, NB4 + 1), dtype=torch.int64)
    buf.scatter_add_(2, t.clamp(max=NB4), hi)
    buf.scatter_add_(2, (t + 1).clamp(max=NB4), lo)
    buf4 = buf[:, :, :NB4] & 0xFFFFFFFF
    got = _merge(buf4, boff, w, nw).numpy()
    want = np.asarray(_merge_mxu(jnp.asarray(buf4.numpy().astype(np.uint32)),
                                 jnp.asarray(boff.numpy().astype(np.int32)), F, B, w, nw, NB4, 8))
    np.testing.assert_array_equal(got, want)
    assert (bb.sum(dim=1).numpy() > 32 * (w - 2)).any() or w == 24


def test_block_route_reads_the_environment_at_each_call():
    from x3_tpu_torch.ops.encode_kernel import block_route

    cases = [({}, "fused"), ({"X3_FUSED_ENCODE": "0"}, "pairs"),
             ({"X3_FUSED_ENCODE": "0", "X3_PALLAS_PACK": "1"}, "walk"),
             ({"X3_FUSED_ENCODE": "1", "X3_PALLAS_PACK": "1"}, "fused")]
    saved = {k: os.environ.pop(k, None) for k in ("X3_FUSED_ENCODE", "X3_PALLAS_PACK")}
    try:
        for env, want in cases:
            assert _with_env(env, block_route) == want, env
            for k in env:
                os.environ.pop(k, None)
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v


def test_encoder_escalates_on_every_block_route():
    """x3_tpu_torch.encode gives the same stream on every route of "block",
    the torch pack included (it truncates at the NW rung, so an NW overflow
    sends the batch again)."""
    import x3_tpu

    rng = np.random.default_rng(60)
    wav = make_mixed(rng, 32 * 23 + 5)
    want = x3_tpu.encode(wav, TINY, engine="numpy").data
    for route in ("block-K2", "block-pairs", "block-K6"):
        env = ROUTES[route][1]
        got = _with_env(env, lambda: xt.encode(wav, port_params(TINY), batch_frames=6, device="cpu"))
        assert got.data == want, route
        assert got.block_width_used > 2


def test_unknown_pack_mode_raises():
    from x3_tpu_torch.ops.encode_kernel import encode_frames

    z = torch.zeros((1, 32), dtype=torch.int16)
    with pytest.raises(ValueError, match="pack_mode"):
        encode_frames(z, torch.ones(1, dtype=torch.int32), port_params(TINY), "mxu")


def test_new_kernel_wrappers_refuse_cpu_tensors():
    from x3_tpu_torch.ops.front_cuda import encode_front_cuda
    from x3_tpu_torch.ops.pack_cuda import pack_blocks_cuda
    from x3_tpu_torch.ops.pack_walk_cuda import pack_walk_cuda

    z = torch.zeros((4, 8), dtype=torch.int32)
    row = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        encode_front_cuda(z, row, row, row, port_params(TINY))
    with pytest.raises(ValueError):
        pack_blocks_cuda(z, z, row, 11)
    with pytest.raises(ValueError):
        pack_walk_cuda(z.reshape(1, 4, 8), z.reshape(1, 4, 8), z[:1, :4], 24, 4)


# ---- kernels K5 and K6 (csrc/pack_blocks.cu, csrc/pack_walk.cu), modelled in numpy ----

M32 = 0xFFFFFFFF


def _cu_source(name):
    from pathlib import Path

    import x3_tpu_torch

    return (Path(x3_tpu_torch.__file__).parent / "csrc" / f"{name}.cu").read_text()


def _cu_consts(name):
    import re

    return {k: int(v) for k, v in re.findall(r"constexpr int k(\w+) = (\d+);", _cu_source(name))}


def _pieces(v, ln, poff):
    """The kernels' two sums of one item (value v, ln bits) at bit offset
    poff: what it adds to the window's word t (`cur`) and to word t+1
    (`nxt`), shifts clipped to 0..31."""
    sh = 32 - (poff & 31) - ln
    shr = np.clip(-sh, 1, 31)
    hi = np.where(sh >= 0, (v << np.clip(sh, 0, 31)) & M32, v >> shr)
    lo = np.where(sh >= 0, 0, (v << (32 - shr)) & M32)
    return hi, lo


class _Window:
    """The sliding two-word window of K5 and K6 over a vector of lanes:
    `cur` sums word t, `nxt` word t+1; when an item's word tn differs from
    t, word t leaves through `emit(s, x, m)`, and on a jump of more than
    one word (lengths outside 0..32) word t+1 leaves too."""

    def __init__(self, poff, emit):
        self.poff = poff.astype(np.int64)
        self.t = self.poff >> 5
        self.cur = np.zeros_like(self.poff)
        self.nxt = np.zeros_like(self.poff)
        self.emit = emit
        self.jumped = np.zeros(self.poff.shape, bool)

    def step(self, v, ln, m=True):
        m = np.broadcast_to(m, self.poff.shape)
        v = np.where(m, v, 0)
        ln = np.where(m, ln, 0)
        tn = self.poff >> 5
        mv = m & (tn != self.t)
        self.emit(self.t, self.cur, mv)
        step = mv & (tn == self.t + 1)
        jump = mv & ~step
        self.emit(self.t + 1, self.nxt, jump)
        self.jumped |= jump
        self.cur = np.where(step, self.nxt, np.where(jump, 0, self.cur))
        self.nxt = np.where(mv, 0, self.nxt)
        self.t = np.where(mv, tn, self.t)
        hi, lo = _pieces(v, ln, self.poff)
        self.cur = (self.cur + hi) & M32
        self.nxt = (self.nxt + lo) & M32
        self.poff = self.poff + ln

    def finish(self, m=True):
        m = np.broadcast_to(m, self.poff.shape)
        self.emit(self.t, self.cur, m)
        self.emit(self.t + 1, self.nxt, m)


def _k5_model(item_val, item_len, r2, nb4):
    """csrc/pack_blocks.cu's arithmetic in numpy, every lane at once: the
    items in batches of kUnroll (zero items past I), the two-word window,
    each finished slot added to the lane's column of the zeroed tile
    (slots outside 0..nb4-1 dropped), the column written out.  Checks that
    for lanes whose lengths are all in 0..32 the window never jumps and
    no slot is added twice."""
    U = _cu_consts("pack_blocks")["Unroll"]
    v = np.asarray(item_val).view(np.uint32).astype(np.int64)
    ln = np.asarray(item_len).astype(np.int64)
    I, N = v.shape
    tile = np.zeros((nb4, N), np.int64)
    adds = np.zeros((nb4, N), np.int64)
    lanes = np.arange(N)

    def emit(s, x, m):
        m = m & (s >= 0) & (s < nb4)
        tile[s[m], lanes[m]] += x[m]  # one slot a lane per call
        adds[s[m], lanes[m]] += 1

    win = _Window(np.asarray(r2)[0], emit)
    for i0 in range(0, I, U):
        for i in range(i0, i0 + U):
            win.step(v[i] if i < I else 0, ln[i] if i < I else 0)
    win.finish()
    inside = ((ln >= 0) & (ln <= 32)).all(axis=0)
    assert not win.jumped[inside].any(), "the window jumped on lengths in 0..32"
    assert (adds[:, inside] <= 1).all(), "a slot was added twice on lengths in 0..32"
    return (tile & M32).astype(np.uint32)


def _k6_model(mval, mlen, block_off, W, L):
    """csrc/pack_walk.cu's arithmetic in numpy, CTA (frame) by CTA and
    chunk by chunk of T blocks, the blocks of a chunk at once: each
    block's reach and the sticky vote that lets it own its inner words,
    then the two-word window into plain stores of owned words and atomic
    adds of the rest, dropped past NB words or outside 0..W-1.  Checks
    that a plainly stored word had no write before it and gets no other
    write in its chunk.  Returns the words and the counts of plain stores
    and of chunks that voted against owned words."""
    from x3_tpu_torch.ops.pack_walk_cuda import walk_buffer_words

    mval = np.asarray(mval).view(np.uint32).astype(np.int64)
    mlen = np.asarray(mlen).astype(np.int64)
    boffs = np.asarray(block_off).astype(np.int64)
    F, B, P = mval.shape
    nb = walk_buffer_words(L)
    T = max(32, min(_cu_consts("pack_walk")["Threads"], -(-B // 32) * 32))  # x3_pack_walk's launch
    out = np.zeros((F, W), np.uint32)
    n_plain = n_unsorted = 0
    for f in range(F):
        sw = np.zeros(W, np.int64)
        written = np.zeros(W, bool)  # by an earlier chunk
        owned_ok = True  # the sticky vote
        for cb0 in range(0, B, T):
            b = np.arange(cb0, min(cb0 + T, B))
            vals, lens = mval[f, b], mlen[f, b]
            boff = boffs[f, b]
            w0 = boff >> 5
            reach = np.zeros(len(b), np.int64)
            if P:
                last = lens[:, -1]
                reach = ((boff & 31) + lens[:, :-1].sum(axis=1) + np.maximum(last, 1) - 1) >> 5
            bad = (boff < 0) | ((lens < 0) | (lens > 32)).any(axis=1)
            nxt_w0 = np.where(b + 1 < B, boffs[f, np.minimum(b + 1, B - 1)] >> 5, 0)
            ok = ~bad & ((b + 1 == B) | (w0 + reach <= nxt_w0))
            owned_ok = bool(ok.all()) and owned_ok
            n_unsorted += not owned_ok
            plain_idx, plain_x, atom_idx, atom_x = [], [], [], []

            def emit(s, x, m):
                w = w0 + s
                keep = m & (s < nb) & (w >= 0) & (w < W)
                plain = keep & owned_ok & (s > 0) & (s < reach)
                atom = keep & ~plain & (x != 0)
                plain_idx.append(w[plain]), plain_x.append(x[plain])
                atom_idx.append(w[atom]), atom_x.append(x[atom])

            win = _Window(boff & 31, emit)
            for p in range(P):
                win.step(vals[:, p], lens[:, p])
            win.finish()
            inside = ~((lens < 0) | (lens > 32)).any(axis=1)
            assert not win.jumped[inside].any(), "the window jumped on lengths in 0..32"
            pi, px = np.concatenate(plain_idx), np.concatenate(plain_x)
            ai, ax = np.concatenate(atom_idx), np.concatenate(atom_x)
            counts = np.bincount(np.concatenate([pi, ai]).astype(np.int64), minlength=W)
            assert not written[pi].any(), "a plain store over an earlier write"
            assert (counts[pi] == 1).all(), "a plainly stored word has another write in its chunk"
            sw[pi] = px
            n_plain += len(pi)
            np.add.at(sw, ai, ax)
            written[pi] = True
            written[ai] = True
        out[f] = (sw & M32).astype(np.uint32)
    return out, n_plain, n_unsorted


def _k5_route_tensors(params, F, seed):
    from x3_tpu_torch.ops._bits import as_i32
    from x3_tpu_torch.ops.encode_kernel import _block_layout, _items, _lanes

    frames, n_valid = _frames(np.random.default_rng(seed), params, F)
    iv, il, _ = _items(torch.from_numpy(frames), torch.from_numpy(n_valid), port_params(params))
    block_off = _block_layout(il.sum(dim=2))[0]
    r2 = (block_off & 255).reshape(1, -1).to(torch.int32)
    return _lanes(as_i32(iv)), _lanes(il), r2


def _pack_blocks_jax(vals, lens, r2, nb4, tile=16):
    import jax.numpy as jnp

    from x3_tpu.ops import pack_pallas

    N = vals.shape[1]
    orig = pack_pallas.LANE_TILE
    pack_pallas.LANE_TILE = tile
    try:
        want = pack_pallas.pack_blocks_pallas(
            jnp.asarray(_pad_lanes(np.asarray(vals).view(np.uint32), tile=tile)),
            jnp.asarray(_pad_lanes(np.asarray(lens), tile=tile)),
            jnp.asarray(_pad_lanes(np.asarray(r2), tile=tile)), nb4, True)
    finally:
        pack_pallas.LANE_TILE = orig
    return np.asarray(want)[:, :N]


@pytest.mark.parametrize("params,nw", [(TINY, 4), (TINY, 2), (TINY, 1), (ODD, 3), (Parameters(), 6)],
                         ids=["tiny-nw4", "tiny-nw2", "tiny-nw1", "odd-nw3", "default-nw6"])
def test_k5_model_on_route_tensors(params, nw):
    """The K5 model equals pack_blocks_plain and the Pallas kernel in
    interpret mode on the tensors the block routes give it, at the full
    rung and at NW rungs that overflow."""
    from x3_tpu_torch.ops.pack_cuda import pack_blocks_plain

    vals, lens, r2 = _k5_route_tensors(params, 3 if params.blocks_per_frame > 100 else 10, 70 + nw)
    nb4 = nw + 7
    got = _k5_model(vals.numpy(), lens.numpy(), r2.numpy(), nb4)
    np.testing.assert_array_equal(got, pack_blocks_plain(vals, lens, r2, nb4).numpy().view(np.uint32))
    np.testing.assert_array_equal(got, _pack_blocks_jax(vals, lens, r2, nb4, tile=128))


@pytest.mark.parametrize("I", [22, 9, 1, 0])
@pytest.mark.parametrize("nb4", [1, 13, 40])
def test_k5_model_on_edge_lanes(nb4, I):
    """The K5 model on chip_smoke's edge lanes (values wider than their
    length, 32-bit items, items ending on a word then zero-length items
    with non-zero values, offsets that skip slots and drop every piece)
    equals pack_blocks_plain and, where there are items, the Pallas kernel
    in interpret mode; item counts on and off the unroll factor."""
    from chip_smoke import k5_edge_batch
    from x3_tpu_torch.ops.pack_cuda import pack_blocks_plain

    vals, lens, r2 = k5_edge_batch(np.random.default_rng(80 + nb4 + I), I, 1000)
    got = _k5_model(vals, lens, r2, nb4)
    t = torch.from_numpy
    np.testing.assert_array_equal(got, pack_blocks_plain(t(vals), t(lens), t(r2), nb4).numpy().view(np.uint32))
    if I:
        np.testing.assert_array_equal(got, _pack_blocks_jax(vals, lens, r2, nb4, tile=200))
    if nb4 == 13 and I == 22:
        assert (got[0] == 0).any() and (got[-1] != 0).any()  # skipped slots; pieces reach the last


def test_k5_edge_lanes_cover_the_quirks():
    """chip_smoke's K5 edge lanes hold the quirks the kernel must keep:
    zero-length items with non-zero values at word-aligned offsets (which
    add v << 31), items ending on a word, 32-bit items, and lanes whose
    every piece drops at nb4 = 13."""
    from chip_smoke import k5_edge_batch

    vals, lens, r2 = k5_edge_batch(np.random.default_rng(1), 22, 1000)
    poff = r2.astype(np.int64) + np.cumsum(lens, axis=0) - lens
    v = vals.view(np.uint32)
    assert ((lens == 0) & (poff % 32 == 0) & (v != 0)).sum() > 50
    assert (((poff + lens) % 32 == 0) & (lens > 0)).sum() > 500
    assert (lens == 32).all(axis=0).sum() > 50
    assert (r2[0] >= 13 * 32).sum() > 20


@pytest.mark.parametrize("params,w", [(TINY, None), (TINY, 8), (ODD, None), (Parameters(), None),
                                      (Parameters(), 512)],
                         ids=["tiny-fit", "tiny-w8", "odd-fit", "default-fit", "default-w512"])
def test_k6_model_on_route_tensors(params, w):
    """The K6 model equals pack_walk_plain on the pairs the block route
    gives it (X3_FUSED_ENCODE=0 X3_PALLAS_PACK=1), at the frame's full
    width and at a compact W that overflows; at the full width it equals
    the port's torch pair pack too, and every block owns its inner words."""
    from x3_tpu_torch.ops._bits import as_i32
    from x3_tpu_torch.ops.encode_kernel import (_block_layout, _items, _pack_pairs, _pairs,
                                                 block_buffer_words, frame_geometry)
    from x3_tpu_torch.ops.pack_walk_cuda import pack_walk_plain

    pp = port_params(params)
    frames, n_valid = _frames(np.random.default_rng(60 + (w or 0)), params,
                              3 if params.blocks_per_frame > 100 else 10)
    iv, il, _ = _items(torch.from_numpy(frames), torch.from_numpy(n_valid), pp)
    mval, mlen = _pairs(iv, il)
    boff, total_bits, _ = _block_layout(mlen.sum(dim=2))
    W = w or frame_geometry(pp)[3]
    args = (as_i32(mval), mlen.to(torch.int32), boff.to(torch.int32))
    got, n_plain, n_unsorted = _k6_model(*(a.numpy() for a in args), W, params.block_len)
    np.testing.assert_array_equal(got, pack_walk_plain(*args, W, params.block_len).numpy().view(np.uint32))
    if w is None:
        want = _pack_pairs(mval, mlen, W, block_buffer_words(pp))[0].numpy()
        np.testing.assert_array_equal(got, want)
    else:
        assert (total_bits.numpy() > 32 * W).any()  # the rung overflows
    assert n_unsorted == 0 and n_plain > 0


@pytest.mark.parametrize("case", list(K6_EDGES))
def test_k6_model_on_edge_frames(case):
    """The K6 model on chip_smoke's edge frames (three of each case) equals
    pack_walk_plain: the route's shape at W = 8, at a compact W that
    overflows and at a W that fits; gaps, word-aligned starts and
    overlapping blocks; lengths past 32 bits; blocks past NB words (L = 4);
    MAX_WORDS and one word less; a frame of one block."""
    from chip_smoke import k6_edge_case
    from x3_tpu_torch.ops.pack_walk_cuda import pack_walk_plain

    mval, mlen, boff, W, L, _ = k6_edge_case(np.random.default_rng(90 + len(case)), case, frames=3)
    got, n_plain, n_unsorted = _k6_model(mval, mlen, boff, W, L)
    t = torch.from_numpy
    np.testing.assert_array_equal(got, pack_walk_plain(t(mval), t(mlen), t(boff), W, L).numpy().view(np.uint32))
    assert (n_unsorted > 0) == (case in ("overlap", "wide"))  # only these give up owned words
    assert n_plain > 0 or case in ("overlap", "wide", "route-W8", "one-block")


@pytest.mark.parametrize("case", ["fit", "overflow", "quirks"])
def test_k6_model_matches_pallas_interpret(case):
    """The K6 model equals pack_frames_walk in interpret mode (geometry
    overrides of tests/test_pack_walk.py) and pack_walk_plain: on the
    route's well-formed pairs (every word when the frames fit, the words
    before the first overflowing block when they overflow W), and on
    packed edge frames (values wider than their length, blocks ending on
    words before zero-length pairs with non-zero values)."""
    from chip_smoke import k6_edge_batch
    from x3_tpu_torch.ops.pack_walk_cuda import pack_walk_plain

    rng = np.random.default_rng(33)
    geo = (2, 256, 2, 3)
    if case == "quirks":
        F, B, P, L, W = 2, 9, 4, 4, 64
        geo = (2, 256, 2, 4)  # NB = walk_buffer_words(4)
        mval, mlen, boff = k6_edge_batch(rng, F, B, P, "packed")
        mlen = np.minimum(mlen, 24).astype(np.int32)  # blocks within NB words of any start
        boff = _pairs_with_offsets(mlen)[0]
        over = None
    else:
        F, B, P, L = (3, 8, 3, 4) if case == "fit" else (2, 12, 3, 4)
        W = 16 if case == "fit" else 4
        mval, mlen = _random_pairs(rng, F, B, P, geo[3])
        if case == "overflow":
            mlen = np.maximum(mlen, 8).astype(np.int32)
            mval = (mval & ((1 << mlen.astype(np.uint64)) - 1)).astype(np.uint32)
        boff, be = _pairs_with_offsets(mlen)
        over = be > W * 32 if case == "overflow" else None
    got = _k6_model(mval, mlen, boff, W, L)[0]
    t = torch.from_numpy
    np.testing.assert_array_equal(
        got, pack_walk_plain(t(mval.view(np.int32)), t(mlen), t(boff), W, L).numpy().view(np.uint32))
    want = _walk_jax(mval.view(np.uint32), mlen, boff, W, L, geo)
    if over is None:
        np.testing.assert_array_equal(got, want)
    else:
        for f in range(F):
            safe = max(0, int(boff[f, np.argmax(over[f])]) // 32 - 1)
            np.testing.assert_array_equal(got[f, :safe], want[f, :safe])
