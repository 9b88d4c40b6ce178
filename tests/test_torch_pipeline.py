"""The port's host pipeline on the CPU, against x3_tpu: the frame assembly
on the device, the decode's word upload, the compacted decode, and the
one-batch-ahead encode loops (models.encoder.encode and
multifile._run_encode_worklist) with their sticky rung escalation."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import x3_tpu_torch as xt
from tests.conftest import make_mixed
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)
# Three width rungs (512, 1024, 1128 words) and four block-width rungs
# (4, 6, 10, 12): noise of amplitude 16 fits W=512, 256 needs 1024 and
# full scale the worst case; each also moves the block-width rung.
ESC = Parameters(block_len=20, blocks_per_frame=110)
QUIET, MEDIUM, LOUD = 16, 256, 32767


def port_params(p: Parameters) -> xt.Parameters:
    return xt.Parameters(**dataclasses.asdict(p))


def _frames_of(blob: bytes):
    payloads, counts, crcs, off = [], [], [], 0
    while off < len(blob):
        h = blob[off : off + 20]
        plen = int.from_bytes(h[6:8], "big")
        counts.append(int.from_bytes(h[4:6], "big"))
        crcs.append(int.from_bytes(h[18:20], "big"))
        payloads.append(blob[off + 20 : off + 20 + plen])
        off += 20 + plen
    return payloads, counts, crcs


def _noise(amps, spf: int, seed: int, tail: int = 0) -> np.ndarray:
    """Frames of uniform noise of the given amplitudes, the last one cut
    `tail` samples short."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.integers(-a, a, spf).astype(np.int16) for a in amps])
    return x[: len(x) - tail]


# -- frame assembly on the device ---------------------------------------------

@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_device_assembly_equals_assemble(data):
    """assemble_frames (the payload bytes gathered on the device, the
    headers written into their holes) gives _assemble's bytes, the port's
    and x3_tpu's, for any frame count, width and payload length."""
    from x3_tpu.models.encoder import _assemble as ref_assemble

    from x3_tpu_torch.models.encoder import _assemble, assemble_frames

    F = data.draw(st.integers(1, 33), label="F")
    wcols = data.draw(st.integers(1, 8), label="wcols")
    nbytes = np.asarray(data.draw(st.lists(st.integers(0, 4 * wcols), min_size=F, max_size=F),
                                  label="nbytes"), dtype=np.int32)
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1), label="seed"))
    words = rng.integers(-(2**31), 2**31, (F, wcols), dtype=np.int64).astype(np.int32)
    headers = rng.integers(0, 256, (F, 20), dtype=np.uint8)
    payload = words.view(np.uint32).byteswap().view(np.uint8).reshape(F, 4 * wcols)
    offsets = np.concatenate([[0], np.cumsum(20 + nbytes.astype(np.int64))])
    got = assemble_frames(headers, torch.from_numpy(words), torch.from_numpy(nbytes), offsets)
    assert got.dtype == np.uint8 and got.tobytes() == _assemble(headers, payload, nbytes)
    assert got.tobytes() == ref_assemble(headers, payload, nbytes)


# -- decode upload and read-back ----------------------------------------------

def _payloads(rng, lengths):
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("case", ["mod4", "empty", "widest"])
def test_word_upload_equals_payload_batch(case, shards):
    """upload_span's device-built words from the payloads joined into one
    buffer (_join) equal payload_words of payload_batch's zero-padded
    buffer, with its sample counts, lengths and pad lanes, for payload
    lengths 0-3 mod 4 and meshes of 2 and 4."""
    from x3_tpu_torch.models.decoder import _join, payload_batch, upload_span
    from x3_tpu_torch.ops.decode_kernel import payload_words

    tiny = port_params(TINY)
    rng = np.random.default_rng(shards)
    lengths = {"mod4": [0, 1, 2, 3, 4, 5, 6, 7, 41, 42, 43, 44, 9],
               "empty": [0, 0, 0],
               "widest": [4 * 24, 4 * 24 - 1, 0, 3, 4 * 24]}[case]
    payloads = _payloads(rng, lengths)
    counts = [32 if k % 3 else 70 for k in range(len(payloads))]  # 70: the n_blocks override
    buf, ns, plens, n_blocks = payload_batch(payloads, counts, tiny, shards)
    cpu = torch.device("cpu")
    words, ns_t, plens_t, nb = upload_span(*_join(payloads, cpu), counts, tiny, cpu, shards)
    assert nb == n_blocks and words.dtype == torch.int32
    assert torch.equal(words, payload_words(torch.from_numpy(buf)))
    np.testing.assert_array_equal(ns_t.numpy(), ns)
    np.testing.assert_array_equal(plens_t.numpy(), plens)


def _corrupt_stream(seed: int):
    """The tiny geometry's payloads of a mixed stream, odd frames with a
    flipped byte, one frame claiming more samples than the geometry holds."""
    tiny = port_params(TINY)
    wav = make_mixed(np.random.default_rng(seed), 32 * 11 + 5)
    payloads, counts, crcs = _frames_of(xt.encode(wav, tiny, device="cpu").data)
    payloads = [bytes(b ^ 0x5A if i == 3 else b for i, b in enumerate(p)) if k % 2 else p
                for k, p in enumerate(payloads)]
    counts[2] = 70
    return tiny, payloads, counts, crcs


@pytest.mark.parametrize("entries", [1, 2, 4])
@pytest.mark.parametrize("checked", [False, True], ids=["plain", "checked"])
def test_decode_frames_flat_is_the_concatenation(checked, entries):
    """decode_frames_flat's samples are decode_frames_batch's arrays back
    to back, error lanes included, with the same err and crc_ok, equal to
    x3_tpu's; on meshes of 1, 2 and 4 CPU entries."""
    from x3_tpu.models.decoder import decode_frames_batch as ref

    from x3_tpu_torch.models.decoder import decode_frames_flat
    from x3_tpu_torch.models.sharding import Mesh

    tiny, payloads, counts, crcs = _corrupt_stream(20 + entries)
    mesh = Mesh(["cpu"] * entries)
    kw = dict(check_crcs=crcs) if checked else {}
    flat = decode_frames_flat(payloads, counts, tiny, device="cpu", mesh=mesh, **kw)
    per = xt.decode_frames_batch(payloads, counts, tiny, device="cpu", mesh=mesh, **kw)
    want = ref(payloads, counts, TINY, **kw)
    assert flat[0].dtype == np.int16 and len(flat[0]) == sum(counts)
    np.testing.assert_array_equal(flat[0], np.concatenate(per[0]))
    np.testing.assert_array_equal(flat[0], np.concatenate(want[0]))
    for g, p, w in zip(flat[1:], per[1:], want[1:]):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)
    assert flat[1].any() and (not checked or not flat[2].all())
    empty = decode_frames_flat([], [], tiny, device="cpu", **kw)
    assert len(empty[0]) == 0 and len(empty) == len(flat)


def test_frame_arrays_are_disjoint_views_equal_to_x3_tpu():
    """decode_frames_batch's arrays share no memory with one another or
    with another call's, and each equals x3_tpu's copy."""
    from x3_tpu.models.decoder import decode_frames_batch as ref

    tiny, payloads, counts, crcs = _corrupt_stream(31)
    a = xt.decode_frames_batch(payloads, counts, tiny, check_crcs=crcs, device="cpu")[0]
    b = xt.decode_frames_batch(payloads, counts, tiny, check_crcs=crcs, device="cpu")[0]
    want = ref(payloads, counts, TINY, check_crcs=crcs)[0]
    for x, y in itertools.combinations(a + b, 2):
        assert not np.shares_memory(x, y)
    for x, w in zip(a, want):
        np.testing.assert_array_equal(x, w)
    before = [x.copy() for x in b]
    for x in a:
        x[...] = -1
    for x, y in zip(b, before):
        np.testing.assert_array_equal(x, y)


# -- the one-batch-ahead encode -----------------------------------------------

def _serial_rungs(wav, params: xt.Parameters, batch_frames: int):
    """(width_used, block_width_used) of a serial loop: each batch starts
    at the stream's sticky rungs and moves them to the first that fit."""
    from x3_tpu_torch.ops.encode_kernel import (
        block_width_rungs, encode_frames, fits_block_width, fits_width, width_rungs)

    spf = params.samples_per_frame
    rungs, nw_rungs = width_rungs(params), block_width_rungs(params)
    rung = nw_rung = 0
    n_frames = -(-len(wav) // spf)
    for base in range(0, n_frames, batch_frames):
        seg = wav[base * spf : (base + batch_frames) * spf]
        f = -(-len(seg) // spf)
        batch = np.zeros((f, spf), np.int16)
        batch.reshape(-1)[: len(seg)] = seg
        n_valid = np.full(f, spf, np.int32)
        n_valid[-1] = len(seg) - (f - 1) * spf
        res = encode_frames(torch.from_numpy(batch), torch.from_numpy(n_valid), params)
        nbytes, blockfit = res["nbytes"].numpy(), res["blockfit_bits"].numpy()
        while rung < len(rungs) - 1 and not fits_width(nbytes, rungs[rung], params):
            rung += 1
        while nw_rung < len(nw_rungs) - 1 and not fits_block_width(blockfit, nw_rungs[nw_rung], params):
            nw_rung += 1
    return rungs[rung], nw_rungs[nw_rung]


def _order_log(monkeypatch, module):
    """Record the calls of `module`'s submit and finish, in order; a
    finish's own re-dispatch (a submit inside it) is not a batch's."""
    from x3_tpu_torch.models import encoder

    submit, finish = encoder.submit, encoder.finish
    log, depth = [], [0]

    def sub(*a, **k):
        if not depth[0]:
            log.append("submit")
        return submit(*a, **k)

    def fin(*a, **k):
        log.append("finish")
        depth[0] += 1
        try:
            return finish(*a, **k)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(module, "submit", sub)
    monkeypatch.setattr(module, "finish", fin)
    return log


def _one_ahead(log) -> bool:
    """Every batch's finish but the last comes after the next batch's
    submit, and there is a finish for every submit."""
    finishes = [i for i, e in enumerate(log) if e == "finish"]
    return (len(finishes) == log.count("submit")
            and all(log[:i].count("submit") >= k + 2 for k, i in enumerate(finishes[:-1])))


# (batch_frames, frame amplitudes, samples cut from the last frame): the
# stream escalates in a batch while the next one, already submitted at the
# old rungs, fits the old rungs, only the new ones, or neither.
ESC_CASES = {
    "b2-next-fits-old": (2, [QUIET, MEDIUM, QUIET, QUIET, QUIET], 7),
    "b2-next-fits-new": (2, [QUIET, MEDIUM, MEDIUM, QUIET, QUIET], 0),
    "b2-next-fits-neither": (2, [QUIET, MEDIUM, LOUD, QUIET, QUIET, QUIET], 1999),
    "b1-each-batch": (1, [QUIET, MEDIUM, QUIET, LOUD, QUIET], 5),
    "b3-tail": (3, [QUIET, QUIET, MEDIUM, LOUD, QUIET, QUIET, QUIET], 2100),
    "b3-one-batch": (3, [MEDIUM, QUIET], 3),
}


@pytest.mark.parametrize("case", list(ESC_CASES))
def test_pipelined_encode_equals_x3_tpu(case, monkeypatch):
    """The one-batch-ahead encode gives x3_tpu's bytes and stats, ends at
    the rungs of the serial loop (the first that fit, sticky, batch after
    batch), and submits batch i + 1 before it finishes batch i."""
    import x3_tpu

    from x3_tpu_torch.models import encoder

    batch, amps, tail = ESC_CASES[case]
    pp = port_params(ESC)
    wav = _noise(amps, ESC.samples_per_frame, seed=len(case), tail=tail)
    log = _order_log(monkeypatch, encoder)
    got = encoder.encode(wav, pp, batch_frames=batch, device="cpu")
    assert _one_ahead(log) and log.count("finish") == -(-len(amps) // batch)
    engines = ("numpy", "jax") if case == "b2-next-fits-neither" else ("numpy",)
    for engine in engines:
        want = x3_tpu.encode(wav, ESC, engine=engine, batch_frames=batch)
        assert got.data == want.data, engine
        np.testing.assert_array_equal(got.stats, want.stats)
    assert (got.width_used, got.block_width_used) == _serial_rungs(wav, pp, batch)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_pipelined_encode_tiny_batches(batch):
    """Tiny geometry, batch_frames 1-3, a partial tail: x3_tpu's bytes."""
    import x3_tpu

    wav = make_mixed(np.random.default_rng(batch), 32 * 7 + batch)
    got = xt.encode(wav, port_params(TINY), batch_frames=batch, device="cpu")
    for engine in ("jax", "numpy"):
        want = x3_tpu.encode(wav, TINY, engine=engine, batch_frames=batch)
        assert got.data == want.data and np.array_equal(got.stats, want.stats)


@pytest.mark.parametrize("batch", [2, 3])
def test_encode_worklist_equals_x3_tpu(batch, monkeypatch):
    """multifile.encode_streams (the worklist driven one batch ahead, the
    batches filled by the read-ahead thread into three staging buffers)
    gives x3_tpu's archives and stats, across escalations, and submits
    batch i + 1 before it finishes batch i."""
    from x3_tpu.multifile import encode_streams as ref

    from x3_tpu_torch import multifile

    spf = ESC.samples_per_frame
    streams = [_noise([QUIET, MEDIUM], spf, 1, tail=100), _noise([QUIET], spf, 2, tail=spf - 1),
               np.zeros(0, np.int16), _noise([LOUD, QUIET, QUIET], spf, 3), _noise([QUIET] * 4, spf, 4, 33)]
    log = _order_log(monkeypatch, multifile)
    got = multifile.encode_streams(streams, port_params(ESC), batch, device="cpu")
    assert _one_ahead(log) and log.count("finish") >= 2
    want = ref(streams, ESC, batch)
    assert [(r.data, r.stats.tolist()) for r in got] == [(r.data, r.stats.tolist()) for r in want]


@pytest.mark.parametrize("where", ["read", "emit"])
def test_encode_worklist_stops_its_reader_on_error(where):
    """An error in a read (on the read-ahead thread) or in an emit (while
    the reader waits for a staging buffer) ends the worklist with that
    error, and the read-ahead thread stops."""
    import threading

    from x3_tpu_torch import multifile
    from x3_tpu_torch.models.sharding import Mesh

    pp = port_params(TINY)
    work = [(0, 32 * i, 32) for i in range(12)]
    calls = []

    def step(what):
        calls.append(what)
        if what == where and calls.count(what) == 2:
            raise OSError("disk gone")

    def read(key, start, n):
        step("read")
        return np.ones(n, np.int16)

    before = threading.active_count()
    with pytest.raises(OSError, match="disk gone"):
        multifile._run_encode_worklist(work, read, lambda *a: step("emit"), pp, 2, 1, Mesh(["cpu"]))
    assert threading.active_count() <= before
