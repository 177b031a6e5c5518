"""The port's examples (``examples/torch/``), the library flows: each runs
in-process with ``--device cpu`` and prints the JAX example's markers
(``tests/test_examples.py``); the examples' own checks are asserted on
what ``main`` returns. Every example raises without a GPU unless the CPU
is asked for."""

import pathlib
import runpy

import numpy as np
import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
    "torch"


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


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        EXAMPLES.glob("*.py")))
def test_example_raises_without_gpu_unless_cpu_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = runpy.run_path(str(EXAMPLES / name))["main"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])


def test_laplace_quickstart(capsys):
    out = run_example("01_laplace_quickstart.py")
    text = capsys.readouterr().out
    assert "marglik after tuning" in text
    assert "should be larger" in text
    assert out["f_var_shape"] == (200, 1, 1)      # JAX's (N, 1, 1)
    assert out["std_gap"] > out["std_data"]
    assert out["marglik_after"] >= out["marglik_before"]


def test_regression(capsys):
    out = run_example("06_regression.py")
    assert "regression example OK" in capsys.readouterr().out
    assert abs(out["sigma"] - 0.3) < 0.15
    assert out["std_out"] > out["std_in"]
    assert np.all(np.isfinite(out["margliks"]))


def test_calibration(capsys):
    out = run_example("03_calibration.py")
    assert "Laplace probit" in capsys.readouterr().out
    # the Laplace predictives calibrate the overfit MAP softmax
    for link in ("probit", "mc"):
        assert np.isfinite(out[link][0])
        assert out[link][1] < out["map"][1]


def test_bayesopt(capsys):
    out = run_example("07_bayesopt.py")
    assert "bayesopt example OK" in capsys.readouterr().out
    assert abs(out["best"] - out["x_star"]) < 0.12


def test_reward_modeling(capsys):
    out = run_example("08_reward_modeling.py")
    assert "reward modeling example OK" in capsys.readouterr().out
    assert out["corr"] > 0.9
    assert np.all(out["reward_std"] > 0)


def test_dict_input_llm_head(capsys):
    out = run_example("12_dict_input_llm_head.py")
    assert "dict-input predictive sums to 1: OK" in capsys.readouterr().out
    assert out["probs"].shape == (8, 3)
    np.testing.assert_allclose(out["probs"].sum(-1), 1.0, atol=1e-5)


def test_gp_calibration(capsys):
    out = run_example("09_gp_calibration.py")
    assert "gp calibration example OK" in capsys.readouterr().out
    assert np.isfinite(out["nll"]) and 0.0 <= out["ece"] <= 1.0


@pytest.mark.parametrize("name", ["01_laplace_quickstart.py",
                                  "12_dict_input_llm_head.py"])
def test_example_under_float64_default_dtype(name, capsys):
    """The examples make their data in float32 themselves: a process whose
    default dtype is float64 (another test module's, a user's) runs them
    unchanged."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        run_example(name)
    finally:
        torch.set_default_dtype(before)
    out = capsys.readouterr().out
    assert "should be larger" in out or "sums to 1: OK" in out
