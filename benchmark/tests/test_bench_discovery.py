"""A configuration, a traffic mix and a per-layer metric added as new
files, with entries added to BENCHMARK.json, are found by name: no file
the benchmark already has is edited."""

import hashlib
import json
import os

import run
import tinyroot


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _write(root, rel, text):
    with open(os.path.join(root, rel), "w") as f:
        f.write(text)


def test_new_config_mix_and_metric_are_found(tmp_path, capsys):
    root = tinyroot.copy_checkout(str(tmp_path))
    before = _digests(root)
    bench_dir = os.path.join(root, "benchmark")
    with open(os.path.join(bench_dir, "configs", "stegcn-cora.json")) as f:
        cfg = json.load(f)
    cfg.update(tinyroot.SMALL["stegcn-cora"], n_nodes=90, hidden_channels=8)
    _write(root, "benchmark/configs/stegcn-newshape.json", json.dumps(cfg))
    with open(os.path.join(bench_dir, "mixes", "marglik.json")) as f:
        mix = json.load(f)
    mix.update(n_checked=1, traced_units=2)
    _write(root, "benchmark/mixes/marglik-pair.json", json.dumps(mix))
    _write(root, "benchmark/metrics/eager_calls.newshape.py",
           "def read(view):\n"
           "    n = view.spans.count.get('eager_step')\n"
           "    return n / view.units if n else None\n")
    with open(os.path.join(bench_dir, "limits",
                           "stegcn-cora.marglik.json")) as f:
        limits = f.read()
    _write(root, "benchmark/limits/stegcn-newshape.pair.json", limits)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="stegcn-newshape",
                                 file="benchmark/configs/"
                                      "stegcn-newshape.json"))
    bench["workloads"].append({"name": "stegcn-newshape.pair",
                               "config": "stegcn-newshape",
                               "traffic": "marglik-pair", "chips": 1,
                               "why": "a new cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "run_s":
            m["workloads"].append("stegcn-newshape.pair")
    bench["per_layer"].append({"name": "eager_calls.newshape",
                               "unit": "calls/run", "better": "lower",
                               "source": "program_span", "layer": "whole run",
                               "moves": "run_s",
                               "workloads": ["stegcn-newshape.pair"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc = run.main(["--workload", "stegcn-newshape.pair", "--seed", "77",
                   "--seconds", "0.5", "--trace", "1"], device="cpu",
                  root=root)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    # on the CPU no step is captured: 20 epochs of a train step, a -log
    # marglik evaluation and a tracking step, and 2 hyper phases of 2
    # hypersteps, all called from Python
    assert result["metrics"]["eager_calls.newshape"]["value"] == 3 * 20 + 4
    after = _digests(root)
    assert {k: after[k] for k in before} == before
