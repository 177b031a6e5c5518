"""Each cell's check, on a small copy of the cell on the CPU, with the
timed path broken underneath in each way the cell can be: ``correct``
comes out false, and true with nothing broken. The harness's look for a
card is skipped; the rest of a run is driven as on the card."""

import importlib.util
import json
import os

import pytest

import run
import tinyroot


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tinyroot.copy_checkout(str(tmp_path_factory.mktemp("faults")))
    return root, tinyroot.add_small_cells(root)


def _driver(root, cell):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    w = {w["name"]: w for w in bench["workloads"]}[cell]
    with open(os.path.join(root, "benchmark", "mixes",
                           f"{w['traffic']}.json")) as f:
        name = json.load(f)["driver"]
    spec = importlib.util.spec_from_file_location(
        f"faults_{name}", os.path.join(root, "benchmark", "drivers",
                                       f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _correct(root, cell, capsys, seed=31):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", "0"], device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


CASES = [("stegcn-cora.marglik", f) for f in
         ("state_unchanged", "adj_unchanged", "half_batch",
          "answer_altered")] + \
        [("sparsegcn-arxiv.train", f) for f in
         ("state_unchanged", "half_batch", "answer_altered")] + \
        [("sparsegcn-arxiv.laplace", f) for f in
         ("prior_untuned", "answer_altered")] + \
        [("stegcn-cora.laplace", f) for f in
         ("half_batch", "answer_altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_path_is_not_correct(small_root, capsys, cell, fault):
    root, cells = small_root
    small = cells[cell]
    with _driver(root, small).FAULTS[fault]():
        result = _correct(root, small, capsys)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES}))
def test_the_sound_path_is_correct(small_root, capsys, cell):
    root, cells = small_root
    result = _correct(root, cells[cell], capsys)
    assert result["correct"] is True, result["compared"]
