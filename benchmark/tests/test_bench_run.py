"""The command refuses to run without a card, and outside a checkout that
holds the program, and prints no result then."""

import shutil
import subprocess
import sys

import torch

from conftest import BENCH, ROOT


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "perf-joint-b64",
                           "--seed", str(2 ** 31 + 77), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        return  # this machine has a card: the refusal is not reachable here
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
