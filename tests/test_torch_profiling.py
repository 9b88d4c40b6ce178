"""The port's profiling hooks, entry points and decode tools on the CPU
(x3_tpu_torch.utils.profiling, entry, tools.decode_parity and
tools.fuzz_soak), against x3_tpu's aot_compile and __graft_entry__ (JAX on
the CPU).  Every comparison is exact."""

import json
import logging

import numpy as np
import pytest
import torch

from tests.conftest import make_mixed
from tests.test_torch_files import port_params
from x3_tpu.params import Parameters

TINY = Parameters(block_len=4, blocks_per_frame=8)
TINY_ARGS = ["--device", "cpu", "--block-len", "4", "--blocks-per-frame", "8"]


def test_aot_compile_like_x3_tpu():
    """The asserts of x3_tpu's own aot_compile test, then the port's encode
    and decode functions against x3_tpu's compiled executables on the same
    inputs: every encode output and (samples, err) equal."""
    from x3_tpu.utils.profiling import aot_compile as ref_aot

    from x3_tpu_torch.utils.profiling import aot_compile

    exes = aot_compile(4, port_params(TINY), device="cpu")
    assert "encode" in exes and "decode" in exes
    S = TINY.samples_per_frame
    wav = np.zeros((4, S), np.int16)
    out = exes["encode"](wav, np.full(4, S, np.int32))
    assert int(np.asarray(out["nbytes"])[0]) > 0
    assert set(aot_compile(4, port_params(TINY), decode=False, device="cpu")) == {"encode"}

    ref = ref_aot(4, TINY)
    rng = np.random.default_rng(11)
    wav = np.stack([make_mixed(rng, S) for _ in range(4)]).astype(np.int16)
    n = np.asarray([S, S - 5, 1, 0], np.int32)
    for i in range(4):
        wav[i, n[i]:] = 0
    got, want = exes["encode"](wav, n), ref["encode"](wav, n)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key].numpy().astype(np.int64) & 0xFFFFFFFF,
                                      np.asarray(want[key]).astype(np.int64) & 0xFFFFFFFF, err_msg=key)
    payload = np.ascontiguousarray(np.asarray(want["payload_words"])).byteswap().view(np.uint8).reshape(4, -1)
    plens = np.array(want["nbytes"], np.int32)
    got_dec, want_dec = exes["decode"](payload, n, plens), ref["decode"](payload, n, plens)
    for g, w in zip(got_dec, want_dec):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got_dec[1].any()


def test_trace_writes_the_annotations(tmp_path, caplog):
    """trace() writes one Chrome trace into its directory, holding the
    span() names of the region, and logs the device events it kept."""
    from x3_tpu_torch.ops.encode_kernel import encode_frames
    from x3_tpu_torch.utils.profiling import span, trace

    pp = port_params(TINY)
    S = TINY.samples_per_frame
    with caplog.at_level(logging.INFO, logger="x3_tpu_torch"):
        with trace(tmp_path / "tr") as prof:
            with span("x3.encode"):
                encode_frames(torch.zeros((4, S), dtype=torch.int16), torch.full((4,), S, dtype=torch.int32), pp)
            with span("x3.outer"), span("x3.inner"):
                torch.ones(3).sum()
    files = list((tmp_path / "tr").iterdir())
    assert files == [tmp_path / "tr" / files[0].name] and str(files[0]) == prof.trace_path
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"x3.encode", "x3.outer", "x3.inner"} <= names
    assert any("device events kept" in r.getMessage() for r in caplog.records)
    with span("x3.untraced"):  # no profiler running: recorded in memory alone
        pass


def test_entry_like_graft_entry():
    """entry(device="cpu") gives the flagship step of __graft_entry__.entry()
    on the same inputs, with every output equal."""
    import __graft_entry__

    from x3_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    ref_fn, ref_args = __graft_entry__.entry()
    for a, r in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), r)
    got, want = fn(*args), ref_fn(*ref_args)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key].numpy().astype(np.int64) & 0xFFFFFFFF,
                                      np.asarray(want[key]).astype(np.int64) & 0xFFFFFFFF, err_msg=key)
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


def test_dryrun_multichip_prints_exact_lines(capsys):
    from x3_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(", nbytes=")[0] for line in lines] == [
        "dryrun_multichip[tiny]: 4 devices on the CPU, 8 frames, roundtrip exact",
        "dryrun_multichip[default]: 4 devices on the CPU, 4 frames, roundtrip exact",
    ]
    assert [len(json.loads(line.split("nbytes=")[1])) for line in lines] == [8, 4]


def _tool(name):
    import importlib

    return importlib.import_module(f"x3_tpu_torch.tools.{name}")


TOOL_ARGS = {
    "decode_parity": ["--frames", "12"],
    "fuzz_soak": ["--trials", "8", "--batches", "8,12", "--seed", "3"],
}


@pytest.fixture(autouse=True)
def _small_plain_calls(monkeypatch):
    """The soak gathers at most 30 lanes a plain call, so a geometry's
    trials take several calls."""
    from x3_tpu_torch.tools import fuzz_soak

    monkeypatch.setattr(fuzz_soak, "PLAIN_LANES", 30)


@pytest.mark.parametrize("name", list(TOOL_ARGS))
def test_tools_exit_0_on_the_cpu(name, capsys):
    assert _tool(name).main(TOOL_ARGS[name] + TINY_ARGS) == 0
    out = capsys.readouterr().out
    assert "holds" in out and "FAIL" not in out


@pytest.mark.parametrize("name", list(TOOL_ARGS))
def test_tools_fail_on_a_planted_divergence(name, monkeypatch, capsys):
    """The plain decode the tools hold K3 to, monkeypatched to flip one
    sample of its last lane: both tools exit 1 and say where."""
    from x3_tpu_torch.ops import decode_cuda

    real = decode_cuda.plain

    def flipped(*args, **kw):
        out, err, off = real(*args, **kw)
        out = out.clone()
        out[-1, 1] ^= 1
        return out, err, off

    monkeypatch.setattr(decode_cuda, "plain", flipped)
    assert _tool(name).main(TOOL_ARGS[name] + TINY_ARGS) == 1
    out = capsys.readouterr().out
    assert "FAIL parity" in out and "lanes differing in samples 1," in out


@pytest.mark.parametrize("summary,device,code", [
    ({"failures": 0, "error_lanes": 9, "launches": 0}, "cpu", 0),
    ({"failures": 0, "error_lanes": 9, "launches": 0}, "cuda", 1),
    ({"failures": 0, "error_lanes": 9, "launches": 3}, "cuda", 0),
    ({"failures": 0, "error_lanes": 0, "launches": 3}, "cuda", 1),
    ({"failures": 1, "error_lanes": 9, "launches": 3}, "cuda", 1),
])
def test_tool_verdicts(summary, device, code, capsys):
    """Exit 1 on a difference, when no lane erred, or on a card when K3
    was never launched."""
    from x3_tpu_torch.tools.fuzz_soak import verdict

    assert verdict(summary, torch.device(device), "soak") == code
    assert ("FAIL" in capsys.readouterr().out) == bool(code)
