"""Nothing the benchmark's run loads has the top-level name jax, jaxlib,
flax or laplace_gnn_tpu (compared whole: laplace_gnn_torch begins with the
JAX package's name), and the plain references import nothing of the
program. Each look runs in a fresh process."""

import ast
import os
import subprocess
import sys
import textwrap

from tinyroot import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "laplace_gnn_tpu"}


def _fresh(code: str) -> str:
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax(tmp_path):
    out = _fresh(f"""
        import json, sys
        sys.path[:0] = [{BENCH_DIR!r}, {os.path.join(BENCH_DIR, 'tests')!r}]
        import tinyroot, run
        root = tinyroot.copy_checkout({str(tmp_path)!r})
        cells = tinyroot.add_small_cells(root)
        for cell in cells.values():
            for trace in ("0", "1"):
                rc = run.main(["--workload", cell, "--seed", "5",
                               "--seconds", "0.5", "--trace", trace],
                              device="cpu", root=root)
                assert rc == 0, (cell, trace, rc)
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """)
    import json
    top = set(json.loads(out))
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "laplace_gnn_torch" in top


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    import run
    base = set(run.forbidden_modules())
    for name in ("laplace_gnn_tpu_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "laplace_gnn_tpu.ops", object())
    assert "laplace_gnn_tpu" in run.forbidden_modules()


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_references_import_nothing_of_the_program():
    refs = os.path.join(BENCH_DIR, "references")
    names = [n for n in os.listdir(refs) if n.endswith(".py")]
    assert names
    for n in names:
        top = _imports(os.path.join(refs, n))
        assert not top & (FORBIDDEN | {"laplace_gnn_torch"}), (n, top)
    for n in ("precision.py", "compare.py", "graphs.py", "counts.py"):
        assert "laplace_gnn_torch" not in _imports(
            os.path.join(BENCH_DIR, "benchlib", n))
    out = _fresh(f"""
        import importlib.util, json, os, sys
        sys.path.insert(0, {BENCH_DIR!r})
        refs = {refs!r}
        for n in sorted(os.listdir(refs)):
            if n.endswith(".py"):
                spec = importlib.util.spec_from_file_location(n[:-3],
                    os.path.join(refs, n))
                spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """)
    import json
    assert not set(json.loads(out)) & (FORBIDDEN | {"laplace_gnn_torch"})
