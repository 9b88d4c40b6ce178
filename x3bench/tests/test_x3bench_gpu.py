"""A short cell on the card, the way the benchmark's checks run it."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.gpu
def test_a_short_cell_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "x3bench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 11), "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["metrics"]["setup_s"]["value"] > 0 and len(result["metrics"]) == 3
