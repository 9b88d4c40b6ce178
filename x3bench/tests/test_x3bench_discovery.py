"""Configurations, traffic mixes and metrics are found by name, so a
later change adds one as files and BENCHMARK.json entries alone."""

from __future__ import annotations

import json
import shutil

import pytest

from x3bench import harness

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.Cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["entry"] and c.traffic["clients"] >= 1
    assert {"setup_s", "host_peak_mb"} <= set(c.end_to_end) <= {m["name"] for m in BENCH["end_to_end"]}
    assert c.per_layer
    direction = c.traffic["direction"]  # its rate, end to end or per layer
    assert f"{direction}_mbs" in c.end_to_end or f"mbs.{direction}" in c.per_layer
    moved = {m["moves"] for m in BENCH["per_layer"] if m["name"] in c.per_layer}
    assert moved <= set(c.end_to_end)  # every per-layer metric moves one the cell reports


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric))


def test_every_config_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"] and conf["reduced"] == c["reduced"]


def test_new_files_are_found_without_editing_the_harness(tmp_path):
    """A configuration, a mix and a metric dropped into a copy of the
    checkout are found by the names a new BENCHMARK.json entry gives."""
    shutil.copytree(ROOT / "x3bench", tmp_path / "x3bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "x3bench/configs/x3rust_eh120.json").read_text())
    conf.update(name="new_rec", streams={"lengths": [123]})
    (tmp_path / "x3bench/configs/new_rec.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "x3bench/traffic/decode_streams_1c.json").read_text())
    mix.update(name="decode_streams_2c", clients=2)
    (tmp_path / "x3bench/traffic/decode_streams_2c.json").write_text(json.dumps(mix))
    (tmp_path / "x3bench/metrics/calls_done.py").write_text("def read(run):\n    return float(len(run.calls))\n")
    bench["configs"].append(dict(bench["configs"][0], name="new_rec", file="x3bench/configs/new_rec.json"))
    bench["workloads"].append({"name": "new.decode", "config": "new_rec", "traffic": "decode_streams_2c",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_done", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "entry points", "moves": "decode_mbs", "workloads": ["new.decode"]})
    bench["end_to_end"][0]["workloads"].append("new.decode")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell("new.decode", root=tmp_path)
    assert cell.config["streams"] == {"lengths": [123]} and cell.traffic["clients"] == 2
    assert "calls_done" in cell.per_layer and "decode_mbs" in cell.end_to_end
    read = harness.load_reader("calls_done", cell.metrics_dir)
    assert read(harness.Run(calls=[1, 2, 3])) == 3.0


@pytest.mark.parametrize("name, direction", [("calls_seen.decode", "decode"), ("calls_seen.encode", "encode"),
                                             ("decode_calls_seen", "decode"), ("encode_calls_seen", "encode")])
def test_a_metric_of_one_direction_shares_its_stems_reader(tmp_path, name, direction):
    """`<stem>.<direction>` and `<direction>_<stem>` without a file of
    their own take metrics/<stem>.py, and read only runs of that direction."""
    (tmp_path / "calls_seen.py").write_text("def read(run):\n    return float(len(run.calls))\n")
    read = harness.load_reader(name, tmp_path)
    other = {"decode": "encode", "encode": "decode"}[direction]
    assert read(harness.Run(direction=direction, calls=[1, 2])) == 2.0
    assert read(harness.Run(direction=other, calls=[1, 2])) is None


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.Cell("no.such.cell")
