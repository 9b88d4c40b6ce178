"""What the benchmark loads and refuses: no module whose top-level name
is jax, jaxlib, flax or x3_tpu (compared whole: x3_tpu_torch is the
program), no result without a card, no result without the program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT

PROBE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/x3bench/tests")
from conftest import run_tiny
result, checks = run_tiny("clips.decode", trace=True)
assert result["correct"], checks
run_tiny("eh120.encode")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = ""
    return env


def test_a_run_loads_no_jax_and_no_x3_tpu_in_a_fresh_interpreter():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "x3_tpu_torch" in names and "x3bench" in names  # the check is not vacuous
    assert not names & {"jax", "jaxlib", "flax", "x3_tpu"}


def test_the_harness_refuses_a_run_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from x3bench import harness

    rc = harness.main(["--workload", "eh120.decode", "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_run_py_refuses_a_directory_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "x3bench", tmp_path / "x3bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "x3bench/run.py", "--workload", "eh120.decode", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, env=_env(),
                         cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "x3_tpu_torch" in out.stderr
