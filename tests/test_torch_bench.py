"""x3_tpu_torch.bench (the port's bench.py) on the CPU at a small geometry:
its corpora equal bench.py's, its JSON has bench.py's keys (read from
bench.py's source), its per-class ratio, compressed MB and rungs equal
x3_tpu's encode_frames and rung functions on the same frames, its e2e
archives equal x3_tpu.files.wav_to_x3a's, every exactness key holds, and
main() prints the JSON last and exits 1 when a decode is damaged.  Exact
(integer codec); the MB/s are CPU numbers and only checked to be
positive."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as ref_bench
from x3_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent
# Two width rungs (512 and 528 words) and three block-width rungs (4, 6, 7),
# so the rung picks are tested; ARGV's smaller geometry keeps main() fast.
FIELDS = dict(block_len=10, blocks_per_frame=100)
BATCH, DECODE_BATCH = 16, 32
SMALL = dict(batch_frames=BATCH, decode_batch=DECODE_BATCH, reps=1, e2e_reps=1, passes=1)
ARGV = ["--device", "cpu", "--batch", str(BATCH), "--decode-batch", str(DECODE_BATCH), "--reps", "1",
        "--e2e-reps", "1", "--block-len", "4", "--blocks-per-frame", "8"]
ADDED = {"device", "torch", "cuda", "decode_batch_frames"}


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    work = tmp_path_factory.mktemp("bench")
    return bench.run("cpu", bench.Parameters(**FIELDS), workdir=work, **SMALL), work


def _bench_py_keys():
    """Keys of bench.py's JSON line and of its per-class dicts, from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    top, per_class = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps":
            top = {k.value for k in node.args[0].keys}
        if isinstance(node, ast.FunctionDef) and node.name in ("bench_class", "bench_e2e"):
            for ret in ast.walk(node):
                if isinstance(ret, ast.Return) and isinstance(ret.value, ast.Dict):
                    per_class |= {k.value for k in ret.value.keys}
    assert top and per_class
    return top, per_class


@pytest.mark.parametrize("seed", [7, 2026])
@pytest.mark.parametrize("name", bench.CLASSES)
def test_corpus_copies(name, seed):
    for n_frames, spf in ((3, 10000), (5, 32)):
        got = bench.make_class_corpus(name, n_frames, spf, seed)
        np.testing.assert_array_equal(got, ref_bench.make_class_corpus(name, n_frames, spf, seed))
    np.testing.assert_array_equal(bench.make_corpus(4, 100, seed), ref_bench.make_corpus(4, 100, seed))
    with pytest.raises(ValueError):
        bench.make_class_corpus("noise", 1, 10)


def test_json_keys_follow_bench_py(result):
    res, _ = result
    top, per_class = _bench_py_keys()
    assert set(res) == (top - {"e2e_jax_encode_mbs"}) | {"e2e_torch_encode_mbs"} | ADDED
    assert set(res["classes"]) == set(bench.CLASSES)
    for c in res["classes"].values():
        assert set(c) == per_class
    json.loads(json.dumps(res))


def test_exactness_keys_and_cpu_nulls(result):
    res, _ = result
    assert res["bit_exact"] is res["decode_exact"] is res["e2e_exact"] is True
    assert all(c["decode_exact"] is c["e2e_exact"] is True for c in res["classes"].values())
    assert res["decode_parity_ok"] is None and res["device"] is None
    assert res["platform"] == "cpu" and res["torch"] == torch.__version__
    assert (res["batch_frames"], res["decode_batch_frames"]) == (BATCH, DECODE_BATCH)
    assert bench.all_exact(res)
    for c in res["classes"].values():
        assert min(c["encode_mbs"], c["decode_mbs"]) > 0


@pytest.mark.parametrize("name", bench.CLASSES)
def test_ratio_and_rungs_match_x3_tpu(result, name):
    """ratio, compressed_mb and the three rungs from x3_tpu's encode_frames
    (XLA on the CPU) and rung functions on the same frames."""
    import jax.numpy as jnp

    from x3_tpu.ops import encode_kernel as ek
    from x3_tpu.params import Parameters

    res, _ = result
    p = Parameters(**FIELDS)
    spf = p.samples_per_frame
    frames = ref_bench.make_class_corpus(name, DECODE_BATCH, spf).reshape(-1, spf)

    def jax_encode(f):
        o = ek.encode_frames(jnp.asarray(f), jnp.full((len(f),), spf, jnp.int32), p)
        return np.asarray(o["nbytes"]), np.asarray(o["blockfit_bits"])

    nbytes, blockfit = jax_encode(frames[:BATCH])
    in_mb = BATCH * spf * 2 / 1e6
    comp_mb = float(nbytes.sum()) / 1e6
    plens, _ = jax_encode(frames[:DECODE_BATCH])
    want = {
        "ratio": round(in_mb / comp_mb, 2),
        "compressed_mb": round(comp_mb, 2),
        "width_rung": next(w for w in ek.width_rungs(p) if ek.fits_width(nbytes, w, p)),
        "block_width_rung": next(nw for nw in ek.block_width_rungs(p) if ek.fits_block_width(blockfit, nw, p)),
        "decode_width_rung": next(r for r in ek.width_rungs(p) if int(plens.max()) <= r * 4),
    }
    assert {k: res["classes"][name][k] for k in want} == want
    if name == "hydrophone":
        assert (res["encode_width_rung"], res["encode_block_width_rung"], res["decode_width_rung"]) == \
            (want["width_rung"], want["block_width_rung"], want["decode_width_rung"])


@pytest.mark.parametrize("name", bench.CLASSES)
def test_e2e_archive_matches_x3_tpu(result, name):
    from x3_tpu.files import wav_to_x3a
    from x3_tpu.params import Parameters

    _, work = result
    d = work / name
    wav_to_x3a(d / "b.wav", d / "ref.x3a", Parameters(**FIELDS), engine="jax")
    assert (d / "b.x3a").read_bytes() == (d / "ref.x3a").read_bytes()


def test_decode_parity_on_cpu():
    """The mutated batch errs on some lanes, and the routed decode (the
    plain version on the CPU) agrees with the plain version."""
    identical, err_lanes = bench.decode_parity(bench.Parameters(block_len=4, blocks_per_frame=8),
                                               torch.device("cpu"))
    assert identical and 0 < err_lanes < bench.PARITY_FRAMES


def test_main_prints_json_last_and_exits_0(capsys):
    assert bench.main(ARGV) == 0
    out = capsys.readouterr().out.strip().splitlines()
    res = json.loads(out[-1])
    assert res["platform"] == "cpu" and res["bit_exact"] is True
    assert set(res["classes"]) == set(bench.CLASSES)


def test_main_exits_1_on_a_damaged_decode(monkeypatch, capsys):
    real = bench.decode_frames

    def flipped(*args, **kw):
        out, err = real(*args, **kw)
        out = out.clone()
        out[0, 1] ^= 1
        return out, err

    monkeypatch.setattr(bench, "decode_frames", flipped)
    assert bench.main(ARGV) == 1
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["decode_exact"] is False and res["bit_exact"] is True


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--device", "cuda", "--batch", "2"])
