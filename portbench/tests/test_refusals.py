"""A run without a card, or without the program beside the benchmark,
fails and prints no result."""
import shutil
import subprocess
import sys

import pytest

from portbench import harness


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "phi3v-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_unknown_workload_refused():
    with pytest.raises(harness.Refused):
        harness.cell("no-such-cell")
