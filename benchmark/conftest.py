"""The harness tests' small copy of ``sparsegat-arxiv``, entered in
``tests/tinyroot.py``'s table of small configurations (read by every
test that builds a small copy of each cell) when pytest collects the
harness tests."""

import os
import sys

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
if TESTS not in sys.path:
    sys.path.insert(0, TESTS)

import tinygat  # noqa: E402
import tinyroot  # noqa: E402

tinyroot.SMALL.setdefault("sparsegat-arxiv", tinygat.SMALL_GAT)
