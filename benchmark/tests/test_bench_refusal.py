"""``run.py`` refuses to measure without a card, and in a checkout that
holds only BENCHMARK.json and the benchmark: no result line, another exit
code than 0. Each run is a process of its own."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tinyroot import BENCH_DIR, ROOT

ARGS = ["--workload", "stegcn-cora.marglik", "--seed", str(2 ** 33 + 9),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def _no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    r = _run(ROOT)
    assert r.returncode != 0
    assert _no_result(r.stdout)
    assert "no CUDA device" in r.stderr


def test_refuses_where_the_card_is_hidden():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ROOT, env)
    assert r.returncode != 0 and _no_result(r.stdout)


def test_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = _run(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and _no_result(r.stdout)
