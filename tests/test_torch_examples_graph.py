"""The port's examples (``examples/torch/``), the graph and distributed
flows: structure learning, the learned-graph figures, the flash GAT, the
sparse scale path, the sharded marglik and the multi-host launch. Each runs
with ``--device cpu`` and prints the JAX example's markers
(``tests/test_examples.py``); the examples' own checks are asserted, the
launch modes against each other, and example 10's scalars against the JAX
example's ``compute`` on the same inputs and weights."""

import os
import pathlib
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"


@pytest.fixture(autouse=True)
def one_thread():
    """The examples run many small eager steps: on one thread each, since
    the test workers share the machine's cores, and torch's default of a
    thread a core in every worker oversubscribes them (50x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_example(name, *argv):
    main = runpy.run_path(str(EXAMPLES / name))["main"]
    return main(["--device", "cpu", *argv])


def run_script(name, *argv, cwd):
    """The example as a user starts it: a fresh interpreter, no LAPLACE_GNN_
    variables (one thread a process, as in ``one_thread``); returns its
    standard output."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LAPLACE_GNN_")}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, str(EXAMPLES / name), "--device",
                        "cpu", *argv], cwd=str(cwd), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_graph_structure_learning(capsys):
    out = run_example("02_graph_structure_learning.py")
    text = capsys.readouterr().out
    assert "learned graph" in text
    assert "Bayes test metrics" in text
    assert len(out["neg_margliks"]) == 80
    assert np.all(np.isfinite(out["neg_margliks"]))
    for metrics in (out["map"], out["bayes"]):
        assert 0.0 <= metrics["acc"] <= 1.0 and np.isfinite(metrics["nll"])


def test_learned_graph_evolution(capsys, tmp_path):
    out = run_example("11_learned_graph_evolution.py", str(tmp_path))
    assert "figures written" in capsys.readouterr().out
    for fn in ("adj_initial.png", "adj_learned.png", "homophily.png",
               "edge_types.png", "degrees.png"):
        assert (tmp_path / fn).exists(), fn
    assert out["epochs"] == [10, 20, 30, 40, 50]


def test_flash_attention_gat(capsys):
    out = run_example("13_flash_attention_gat.py")
    text = capsys.readouterr().out
    assert "flash GAT marglik training" in text
    assert "predictive rows" in text
    assert len(out["neg_margliks"]) == 12
    assert np.all(np.isfinite(out["neg_margliks"]))
    np.testing.assert_allclose(out["row_sums"], 1.0, atol=1e-5)


def test_sparse_scale(capsys):
    out = run_example("04_sparse_scale.py")
    text = capsys.readouterr().out
    assert "SBM: 20000 nodes" in text and "30 steps, final loss" in text
    assert np.isfinite(out["loss"]) and out["loss"] < 0.5
    assert out["out"] is None          # no group of two or more ranks


def test_sparse_scale_over_two_ranks(tmp_path):
    """Two processes launched as a user launches them (the LAPLACE_GNN_
    variables, a file rendezvous): each trains the model and runs the
    edge-partitioned SpMM on its block of 10000 rows."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LAPLACE_GNN_")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(EXAMPLES / "04_sparse_scale.py"), "--device",
         "cpu"], cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(env, LAPLACE_GNN_COORDINATOR=f"file://{tmp_path}/rdzv",
                 LAPLACE_GNN_NUM_PROCESSES="2",
                 LAPLACE_GNN_PROCESS_ID=str(rank)))
        for rank in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        assert "30 steps, final loss" in out
        assert (f"[rank {rank}/2] edge-partitioned aggregation over "
                "{'graph': 2, 'model': 1} mesh: rows (10000, 64) of "
                "(20000, 64)") in out, out[-2000:]


def _ranks(text):
    return [tuple(float(v) for v in m) for m in re.findall(
        r"after 10 sharded steps: loss ([\d.]+) neg_marglik ([\d.]+) "
        r"train acc ([\d.]+)", text)]


def test_distributed_marglik(capsys, tmp_path):
    """A bare run is one rank; ``--spawn 2`` runs two Gloo ranks with the
    ring halo schedule. The scalars are replicated: both ranks print the
    same, and they agree with the bare run within f32 rounding of the
    summation order (rtol 1e-5)."""
    out = run_example("05_distributed_marglik.py")
    bare = capsys.readouterr().out
    assert "distributed marglik pipeline OK" in bare
    assert np.isfinite(out["loss"]) and np.isfinite(out["neg_marglik"])
    spawned = run_script("05_distributed_marglik.py", "--spawn", "2",
                         "--schedule", "ring", cwd=tmp_path)
    assert "distributed marglik pipeline OK" in spawned
    assert "schedule=ring" in spawned
    assert "[rank 0/2]" in spawned and "[rank 1/2]" in spawned
    (b,), s = _ranks(bare), _ranks(spawned)
    assert len(s) == 2 and s[0] == s[1], s
    np.testing.assert_allclose(s[0][:2], b[:2], rtol=1e-5)
    assert abs(s[0][2] - b[2]) <= 1 / 1024 + 1e-9   # at most one node


def _scalars(text):
    return sorted(set(re.findall(r"neg_marglik=([\d.]+) \|grad\|=([\d.]+)",
                                 text)))


def test_multihost_launch_example(tmp_path):
    """The env-var launch path end to end: single-process and a real
    2-process Gloo run (a 'dcn' slice each) print identical replicated
    scalars."""
    single = run_script("10_multihost_launch.py", cwd=tmp_path)
    assert "[single process]" in single
    spawned = run_script("10_multihost_launch.py", "--spawn", "2",
                         cwd=tmp_path)
    assert "[process 0/2]" in spawned and "[process 1/2]" in spawned
    assert "'dcn': 2" in spawned
    s1, s2 = _scalars(single), _scalars(spawned)
    assert len(s1) == 1 and len(s2) == 1, (s1, s2)
    assert s1 == s2, (s1, s2)


def test_multihost_scalars_match_jax_example(tmp_path):
    """The port's ``compute`` against the JAX example's own ``compute`` on
    the same numpy inputs (``default_rng(7)``) and the JAX weights
    (``PRNGKey(1)``, carried over with ``params_from_numpy``): the -log
    marglik and the gradient norm within 1e-4 relative (the JAX side in
    float32 inputs, the port in float64)."""
    import jax
    import torch.distributed as dist
    from laplace_gnn_tpu.graph.container import \
        sparse_from_edge_index as j_sparse
    from laplace_gnn_tpu.models import SparseGCN as JSparseGCN
    from laplace_gnn_tpu.parallel import make_hybrid_mesh as j_mesh
    from laplace_gnn_torch.utils.pytree import params_from_numpy

    jax_compute = runpy.run_path(
        str(REPO / "examples" / "10_multihost_launch.py"))["compute"]
    want = jax_compute(j_mesh())
    rng = np.random.default_rng(7)
    n, d, c = 64, 16, 4
    ei = np.stack([rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)])
    X = rng.standard_normal((n, d)).astype(np.float32)
    jm = JSparseGCN(d, 16, c, 2, X, j_sparse(ei, n, normalize="sym"),
                    dropout_p=0.0)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))

    ns = runpy.run_path(str(EXAMPLES / "10_multihost_launch.py"))
    ns["initialize"](f"file://{tmp_path}/rendezvous", 1, 0, device="cpu")
    try:
        mesh = ns["make_hybrid_mesh"](device="cpu")
        got = ns["compute"](mesh, "cpu", params_from_numpy(jp, device="cpu"))
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=1e-4)
