"""The port's multi-file layer on the CPU (device="cpu"): encode_streams,
decode_streams, wav_to_x3a_batch, x3a_to_wav_batch, streaming.
encode_channels and parallel.multihost.shard_worklist, against x3_tpu's
(JAX on the CPU) and the oracle.  Every comparison is exact: archives,
WAVs and statistics byte for byte and sample for sample, errors by class.
Small geometry (TINY, 32 samples a frame) wherever the parameters are
ours to choose, since XLA:CPU compile time grows fast with the decode
width."""

import numpy as np
import pytest

from tests.conftest import make_hydrophone, make_mixed
from tests.test_torch_files import _odd_wav, _restamp, outcome, port_params, signal, write_wav
from x3_tpu.params import Parameters

P = Parameters()
TINY = Parameters(block_len=4, blocks_per_frame=8)
S = TINY.samples_per_frame
RATES = (8000, 44100, 96000, 22050, 16000, 48000)


def _streams(kind: str, lengths, seed: int = 0):
    rng = np.random.default_rng(seed)
    # make_mixed needs six samples or more; shorter streams are hydrophone.
    return [(make_mixed if kind == "mixed" and n >= 6 else make_hydrophone)(rng, n) for n in lengths]


def _signal(seed: int, n: int) -> np.ndarray:
    """test_torch_files.signal, which needs twelve samples or more."""
    return signal(seed, n) if n >= 12 else make_hydrophone(np.random.default_rng(seed), n)


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.data == w.data and g.nbytes == w.nbytes
        assert g.stats.dtype == np.int64
        np.testing.assert_array_equal(g.stats, w.stats)


# ---- encode_streams and encode_channels ----


@pytest.mark.parametrize("kind", ["hydrophone", "mixed"])
def test_encode_streams_like_x3_tpu_and_oracle(kind):
    """Streams of 0, 1, 5,000, 10,000 and 25,000 samples in 3-frame
    batches: the rungs escalate across streams, and each stream's frames
    and statistics are its own."""
    from x3_tpu import multifile as ref
    from x3_tpu.models import oracle

    from x3_tpu_torch import multifile as port

    streams = _streams(kind, [0, 1, 5_000, 10_000, 25_000])
    got = port.encode_streams(streams, port_params(P), batch_frames=3, device="cpu")
    want = ref.encode_streams(streams, P, batch_frames=3)
    _same_results(got, want)
    for s, g in zip(streams, got):
        assert g.data == oracle.encode(s, P)


@pytest.mark.parametrize("batch", [1, 2, 7, None])
def test_encode_streams_tiny_batches_and_source_id(batch):
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    streams = [_signal(k, n) for k, n in enumerate([3 * S + 5, 0, S, 1, 9 * S - 1])]
    got = port.encode_streams(streams, port_params(TINY), batch, source_id=5, device="cpu")
    _same_results(got, ref.encode_streams(streams, TINY, batch, source_id=5))


def test_encode_channels_like_x3_tpu():
    from x3_tpu import streaming as ref
    from x3_tpu.models import oracle

    from x3_tpu_torch import streaming as port

    rng = np.random.default_rng(4)
    chans = np.stack([make_hydrophone(rng, 12_000), make_mixed(rng, 12_000),
                      make_hydrophone(rng, 12_000, amplitude=12.0), np.zeros(12_000, np.int16)])
    got = port.encode_channels(chans, port_params(P), device="cpu")
    _same_results(got, ref.encode_channels(chans, P))
    for c, g in zip(chans, got):
        assert g.data == oracle.encode(c, P)
    # A 1-D capture is one channel.
    _same_results(port.encode_channels(chans[1], port_params(P), device="cpu"), got[1:2])


# ---- wav_to_x3a_batch and x3a_to_wav_batch ----

LENGTHS = [2 * S + 7, 0, 1, S, 5 * S + 31, 2 * S - 1]


def _wavs(tmp_path):
    paths, wavs = [], []
    for i, n in enumerate(LENGTHS):
        wavs.append(_signal(20 + i, n))
        paths.append(write_wav(tmp_path / f"in{i}.wav", wavs[-1], RATES[i]))
    return paths, wavs


@pytest.mark.parametrize("batch", [1, 4, None])
def test_wav_to_x3a_batch_like_x3_tpu(tmp_path, batch):
    """Six WAVs of mixed lengths and rates (one empty): each archive equals
    x3_tpu's batch archive and the port's single-file archive, and the
    results equal x3_tpu's.  A longer earlier output is cut to size."""
    from x3_tpu import multifile as ref

    from x3_tpu_torch import files
    from x3_tpu_torch import multifile as port

    srcs, _ = _wavs(tmp_path)
    outs = [tmp_path / f"port{i}.x3a" for i in range(len(srcs))]
    outs[0].write_bytes(bytes(range(256)) * 40)  # stale, longer than the archive
    refs = [tmp_path / f"ref{i}.x3a" for i in range(len(srcs))]
    got = port.wav_to_x3a_batch(srcs, outs, port_params(TINY), batch, device="cpu")
    _same_results(got, ref.wav_to_x3a_batch(srcs, refs, TINY, batch))
    for i, (o, r) in enumerate(zip(outs, refs)):
        files.wav_to_x3a(srcs[i], tmp_path / "single.x3a", port_params(TINY), device="cpu")
        assert o.read_bytes() == r.read_bytes() == (tmp_path / "single.x3a").read_bytes(), i
    assert got[0].data == b"" and got[1].nbytes == 0 and got[2].nbytes == 20 + 2


@pytest.mark.parametrize("batch", [4, None])
def test_x3a_to_wav_batch_like_x3_tpu(tmp_path, batch):
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    srcs, _ = _wavs(tmp_path)
    x3as = [tmp_path / f"a{i}.x3a" for i in range(len(srcs))]
    port.wav_to_x3a_batch(srcs, x3as, port_params(TINY), device="cpu")
    backs = [tmp_path / f"back{i}.wav" for i in range(len(srcs))]
    backs[3].write_bytes(b"\x01" * 5000)  # stale, longer than the WAV
    refs = [tmp_path / f"ref{i}.wav" for i in range(len(srcs))]
    got = port.x3a_to_wav_batch(x3as, backs, batch, device="cpu")
    assert got == ref.x3a_to_wav_batch(x3as, refs, batch) == LENGTHS
    for s, b, r in zip(srcs, backs, refs):
        assert b.read_bytes() == r.read_bytes() == s.read_bytes()


def test_decode_streams_mixed_params_and_rates():
    """Archives of different Parameters and rates (and one with no frames)
    decode in one call, each group with its own geometry; a TINY archive
    reads back with the XML's default blocks_per_frame."""
    from x3_tpu import archive
    from x3_tpu.models import oracle

    from x3_tpu_torch import multifile as port

    rng = np.random.default_rng(9)
    odd = Parameters(block_len=7, blocks_per_frame=3)
    cases = [(P, 96000, make_hydrophone(rng, 12_345)), (TINY, 44100, make_mixed(rng, 100)),
             (P, 22050, make_hydrophone(rng, 90)), (odd, 8000, make_mixed(rng, 60)),
             (TINY, 16000, np.zeros(0, np.int16))]
    archives = [archive.build_archive_header(rate, p) + oracle.encode(s, p) for p, rate, s in cases]
    got = port.decode_streams(archives, batch_frames=3, device="cpu")
    assert [r for _, r in got] == [rate for _, rate, _ in cases]
    for (samples, _), (_, _, s) in zip(got, cases):
        assert samples.dtype == np.int16
        np.testing.assert_array_equal(samples, s)


# ---- damage: the error classes of x3_tpu ----


def _damage(path, frame: int, kind: str) -> None:
    """Damage one frame of an archive file in place: a payload byte (the
    CRC then fails), a decode error under a consistent CRC, or a header
    byte (the walk fails)."""
    from x3_tpu import archive

    data = bytearray(path.read_bytes())
    _, hdr_end = archive.parse_archive_header(bytes(data))
    off, h = list(archive.walk_frames(bytes(data), hdr_end))[frame]
    if kind == "crc":
        data[off + 3] ^= 0x10
    elif kind == "decode":
        data[off + 2] = 0b00_0010_00  # a BFP block of 3 bits; the CRC re-stamped
        _restamp(data, off, h)
    else:
        data[off - 20 + 5] ^= 0x01
    path.write_bytes(bytes(data))


# (archive, frame, kind) of each damage; archive 4 has 6 frames, 0 has 3.
DAMAGE = {
    "crc": [(4, 3, "crc")],
    "decode": [(4, 4, "decode")],
    "decode-then-crc": [(0, 1, "decode"), (4, 3, "crc")],
    "crc-then-header": [(0, 2, "crc"), (4, 1, "header")],
    "header": [(3, 0, "header")],
}


@pytest.fixture
def damaged_set(tmp_path, request):
    from x3_tpu_torch import multifile as port

    srcs, _ = _wavs(tmp_path)
    x3as = [tmp_path / f"a{i}.x3a" for i in range(len(srcs))]
    port.wav_to_x3a_batch(srcs, x3as, port_params(TINY), device="cpu")
    for ai, fi, kind in DAMAGE[request.param]:
        _damage(x3as[ai], fi, kind)
    return x3as


@pytest.mark.parametrize("batch", [4, None])
@pytest.mark.parametrize("damaged_set", list(DAMAGE), indirect=True)
def test_x3a_to_wav_batch_damage_like_x3_tpu(damaged_set, tmp_path, batch):
    """The class raised and every WAV written before it (a CRC mismatch of
    a batch is found before its decode errors, after every earlier batch)."""
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    results = []
    for who, fn in (("port", lambda o: port.x3a_to_wav_batch(damaged_set, o, batch, device="cpu")),
                    ("ref", lambda o: ref.x3a_to_wav_batch(damaged_set, o, batch))):
        outs = [tmp_path / f"{who}{i}.wav" for i in range(len(damaged_set))]
        results.append((outcome(lambda: fn(outs)), [o.read_bytes() if o.exists() else None for o in outs]))
    assert results[0] == results[1]
    assert results[0][0][0] == "raise"


@pytest.mark.parametrize("damaged_set", list(DAMAGE), indirect=True)
def test_decode_streams_damage_like_x3_tpu(damaged_set):
    """Every archive's CRCs are checked, in order, before any frame is
    decoded: a CRC mismatch in a later archive wins over a decode error in
    an earlier one, and a CRC mismatch over a later archive's bad header."""
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    archives = [p.read_bytes() for p in damaged_set]
    want = outcome(lambda: ref.decode_streams(archives, batch_frames=4))
    assert want[0] == "raise"
    for batch in (4, None):
        assert outcome(lambda: port.decode_streams(archives, batch_frames=batch, device="cpu")) == want


@pytest.mark.parametrize("kind", ["stereo", "8-bit"])
def test_wav_to_x3a_batch_rejects_what_x3_tpu_rejects(tmp_path, kind):
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    good = write_wav(tmp_path / "good.wav", signal(3, 2 * S), 8000)
    srcs = [good, _odd_wav(tmp_path / "odd.wav", kind)]
    want = outcome(lambda: ref.wav_to_x3a_batch(srcs, [tmp_path / "r0.x3a", tmp_path / "r1.x3a"], TINY))
    assert want[0] == "raise"
    got = outcome(lambda: port.wav_to_x3a_batch(srcs, [tmp_path / "p0.x3a", tmp_path / "p1.x3a"],
                                                port_params(TINY), device="cpu"))
    assert got == want
    assert not (tmp_path / "p0.x3a").exists()  # nothing is written before every WAV is checked


# ---- worklist sharding ----


@pytest.mark.parametrize("n,index,count", [(5, 0, 2), (5, 1, 2), (7, 2, 3), (2, 3, 4), (0, 0, 1), (6, 0, 1)])
def test_shard_worklist_like_x3_tpu(n, index, count):
    from x3_tpu.parallel import multihost as ref

    from x3_tpu_torch.parallel import multihost as port

    items = [f"f{i}" for i in range(n)]
    assert port.shard_worklist(iter(items), index, count) == ref.shard_worklist(items, index, count)
    shards = [port.shard_worklist(items, i, count) for i in range(count)]
    assert sorted(x for s in shards for x in s) == sorted(items)


@pytest.mark.parametrize("index,count", [(-1, 2), (2, 2), (0, 0), (5, 3)])
def test_shard_worklist_out_of_range_like_x3_tpu(index, count):
    from x3_tpu.parallel import multihost as ref

    from x3_tpu_torch.parallel import multihost as port

    want = outcome(lambda: ref.shard_worklist(range(4), index, count))
    assert want == ("raise", "ValueError")
    assert outcome(lambda: port.shard_worklist(range(4), index, count)) == want


def test_shard_worklist_defaults_from_torch_distributed(monkeypatch):
    """Outside a process group the default is the identity; inside one, the
    rank and world size of torch.distributed."""
    import torch.distributed as dist

    from x3_tpu_torch.parallel.multihost import shard_worklist

    items = list(range(10))
    assert not dist.is_initialized()
    assert shard_worklist(items) == items
    assert shard_worklist(items, process_count=3) == items[0::3]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    assert shard_worklist(items) == items[1::3]
    assert shard_worklist(items, process_index=2) == items[2::3]


def test_sharded_batch_conversion_like_x3_tpu(tmp_path):
    """Two processes' shards, each converted alone, give the archives of one
    unsharded call; each process writes only its own outputs, as in
    x3_tpu, and the decode side roundtrips by shards too."""
    from x3_tpu import multifile as ref

    from x3_tpu_torch import multifile as port

    srcs, _ = _wavs(tmp_path)
    whole = [tmp_path / f"whole{i}.x3a" for i in range(len(srcs))]
    port.wav_to_x3a_batch(srcs, whole, port_params(TINY), 4, device="cpu")
    for who in ("port", "ref"):
        outs = [tmp_path / f"{who}{i}.x3a" for i in range(len(srcs))]
        for pi in range(2):
            if who == "port":
                res = port.wav_to_x3a_batch(srcs, outs, port_params(TINY), 4, process_index=pi,
                                            process_count=2, device="cpu")
            else:
                res = ref.wav_to_x3a_batch(srcs, outs, TINY, 4, process_index=pi, process_count=2)
            assert len(res) == len(srcs[pi::2])
            if pi == 0:
                assert [o.exists() for o in outs] == [i % 2 == 0 for i in range(len(srcs))]
        assert [o.read_bytes() for o in outs] == [w.read_bytes() for w in whole]
    backs = [tmp_path / f"back{i}.wav" for i in range(len(srcs))]
    counts = [port.x3a_to_wav_batch(whole, backs, 4, process_index=pi, process_count=2, device="cpu")
              for pi in range(2)]
    assert counts == [LENGTHS[0::2], LENGTHS[1::2]]
    assert [b.read_bytes() for b in backs] == [s.read_bytes() for s in srcs]


# ---- a mesh, and a card that is not there ----

ENTRY_POINTS = {
    "encode_streams": lambda m, a, o, **kw: m.multifile.encode_streams([np.zeros(40, np.int16)], **kw),
    "decode_streams": lambda m, a, o, **kw: m.multifile.decode_streams([a["x3a"].read_bytes()], **kw),
    "wav_to_x3a_batch": lambda m, a, o, **kw: m.multifile.wav_to_x3a_batch([a["wav"]], [o], **kw),
    "x3a_to_wav_batch": lambda m, a, o, **kw: m.multifile.x3a_to_wav_batch([a["x3a"]], [o], **kw),
    "encode_channels": lambda m, a, o, **kw: m.streaming.encode_channels(np.zeros((2, 40), np.int16), **kw),
}


def _inputs(tmp_path):
    from x3_tpu_torch import files

    src = write_wav(tmp_path / "in.wav", np.arange(40, dtype=np.int16))
    files.wav_to_x3a(src, tmp_path / "in.x3a", device="cpu")
    return {"wav": src, "x3a": tmp_path / "in.x3a"}


def _mesh_inputs(tmp_path):
    """Many TINY frames for the mesh runs: _wavs' six WAVs (13 frames) and
    their archives, and streams and a 4-channel capture of 25 frames."""
    from x3_tpu_torch import multifile as port

    srcs, _ = _wavs(tmp_path)
    x3as = [tmp_path / f"a{i}.x3a" for i in range(len(srcs))]
    port.wav_to_x3a_batch(srcs, x3as, port_params(TINY), device="cpu")
    streams = [_signal(40 + k, n) for k, n in enumerate([3 * S + 5, 0, S, 1, 9 * S - 1, 11 * S + 2])]
    chans = np.stack([_signal(50 + c, 5 * S + 3) for c in range(4)])
    return {"wavs": srcs, "x3as": x3as, "streams": streams, "chans": chans}


def _mesh_run(entry, pkg, inp, tmp_path, tag, mesh, **kw):
    """What `entry` of package `pkg` (x3_tpu or x3_tpu_torch) returns and
    writes on the mesh inputs, at batch_frames 3 (encode) or 7 (decode),
    neither a multiple of 4."""
    import importlib

    m = importlib.import_module(f"{pkg}.multifile")
    params = TINY if pkg == "x3_tpu" else port_params(TINY)
    if entry == "encode_streams":
        return [(r.data, r.stats.tolist()) for r in m.encode_streams(inp["streams"], params, 3, mesh=mesh, **kw)]
    if entry == "encode_channels":
        st = importlib.import_module(f"{pkg}.streaming")
        return [(r.data, r.stats.tolist()) for r in st.encode_channels(inp["chans"], params, mesh=mesh, **kw)]
    if entry == "decode_streams":
        return [(x.tobytes(), rate) for x, rate in
                m.decode_streams([p.read_bytes() for p in inp["x3as"]], 7, mesh=mesh, **kw)]
    if entry == "wav_to_x3a_batch":
        outs = [tmp_path / f"{tag}{i}.x3a" for i in range(len(inp["wavs"]))]
        res = m.wav_to_x3a_batch(inp["wavs"], outs, params, 3, mesh=mesh, **kw)
        return [(r.nbytes, r.stats.tolist()) for r in res], [o.read_bytes() for o in outs]
    outs = [tmp_path / f"{tag}{i}.wav" for i in range(len(inp["x3as"]))]
    counts = m.x3a_to_wav_batch(inp["x3as"], outs, 7, mesh=mesh, **kw)
    return counts, [o.read_bytes() for o in outs]


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_mesh_matches_unsharded(tmp_path, entry):
    """Every batch entry point with a 4-entry CPU mesh (batches rounded up
    to a multiple of 4) gives what it gives without a mesh, and what
    x3_tpu gives with its 8-device mesh."""
    from x3_tpu.parallel.mesh import make_mesh as ref_mesh

    from x3_tpu_torch.parallel.mesh import make_mesh

    inp = _mesh_inputs(tmp_path)
    got = _mesh_run(entry, "x3_tpu_torch", inp, tmp_path, "mesh", make_mesh(["cpu"] * 4), device="cpu")
    assert got == _mesh_run(entry, "x3_tpu_torch", inp, tmp_path, "none", None, device="cpu")
    assert got == _mesh_run(entry, "x3_tpu", inp, tmp_path, "ref", ref_mesh())
    if entry == "x3a_to_wav_batch":
        assert got[0] == LENGTHS and got[1] == [w.read_bytes() for w in inp["wavs"]]


@pytest.mark.parametrize("damaged_set", ["decode-then-crc"], indirect=True)
def test_mesh_damage_raises_like_unsharded(damaged_set, tmp_path):
    """A damaged archive set under a 4-entry mesh raises the class it
    raises without one, after writing the same WAVs, and as x3_tpu does
    with its mesh: at 10 frames a batch (12 with the mesh) the decode error
    and the CRC mismatch share the first batch, and the CRC, checked on
    the shards' devices, wins."""
    from x3_tpu import multifile as ref
    from x3_tpu.parallel.mesh import make_mesh as ref_mesh

    from x3_tpu_torch import multifile as port
    from x3_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(["cpu"] * 4)
    results = []
    for who, fn in (
        ("mesh", lambda o: port.x3a_to_wav_batch(damaged_set, o, 10, mesh=mesh, device="cpu")),
        ("none", lambda o: port.x3a_to_wav_batch(damaged_set, o, 10, device="cpu")),
        ("ref", lambda o: ref.x3a_to_wav_batch(damaged_set, o, 10, mesh=ref_mesh())),
    ):
        outs = [tmp_path / f"{who}{i}.wav" for i in range(len(damaged_set))]
        results.append((outcome(lambda: fn(outs)), [o.read_bytes() if o.exists() else None for o in outs]))
    assert results[0] == results[1] == results[2]
    assert results[0][0] == ("raise", "FrameHeaderInvalidPayloadCRC")
    archives = [p.read_bytes() for p in damaged_set]
    got = outcome(lambda: port.decode_streams(archives, 10, mesh=mesh, device="cpu"))
    assert got == outcome(lambda: port.decode_streams(archives, 10, device="cpu")) == \
        outcome(lambda: ref.decode_streams(archives, 10, mesh=ref_mesh())) == results[0][0]


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda(tmp_path, entry):
    """Called without `device`, every entry point asks for the card; with
    none here, it raises and writes nothing."""
    import torch

    import x3_tpu_torch.multifile
    import x3_tpu_torch.streaming

    assert not torch.cuda.is_available()
    out = tmp_path / ("out.wav" if entry == "x3a_to_wav_batch" else "out.x3a")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[entry](x3_tpu_torch, _inputs(tmp_path), out)
    assert not out.exists()


def test_lazy_package_exports():
    import x3_tpu
    import x3_tpu_torch
    from x3_tpu_torch import channel, engine, errors, multifile, streaming

    assert x3_tpu_torch.wav_to_x3a_batch is multifile.wav_to_x3a_batch
    assert x3_tpu_torch.x3a_to_wav_batch is multifile.x3a_to_wav_batch
    assert x3_tpu_torch.X3Error is errors.X3Error
    assert x3_tpu_torch.Channel is channel.Channel and x3_tpu_torch.IterChannel is channel.IterChannel
    assert x3_tpu_torch.StreamEncoder is streaming.StreamEncoder
    assert x3_tpu_torch.resolve_engine is engine.resolve_engine
    assert set(x3_tpu.__all__) <= set(x3_tpu_torch.__all__)
    for name in x3_tpu_torch.__all__:
        getattr(x3_tpu_torch, name)
    with pytest.raises(AttributeError):
        x3_tpu_torch.no_such_name
