"""Flat parameter-dict utilities.

Counterpart of ``laplace_gnn_tpu/utils/pytree.py``. The port keeps
parameters as a flat ``{dotted path: tensor}`` dict whose names are the JAX
pytree paths (``adj``, ``convs.0.lin.bias``). :func:`named_leaves` orders
them as ``jax.tree_util`` flattens the nested tree (dict keys sorted, list
entries by index), so Kron blocks and flat vectors line up with the JAX
package. Parameters whose path contains ``adj`` or ``norms`` are excluded
from the Laplace posterior, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device

DEFAULT_EXCLUDE = ("adj", "norms")


def path_key(name: str) -> tuple:
    """Sort key of a dotted path in JAX tree-flatten order."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in name.split("."))


def named_leaves(params: dict) -> list[tuple[str, Any]]:
    """(dotted path, leaf) pairs in JAX tree order."""
    return sorted(params.items(), key=lambda kv: path_key(kv[0]))


def path_mask(params: dict, predicate: Callable[[str], bool]) -> dict:
    """``{name: bool}`` mask from a path-string predicate."""
    return {k: bool(predicate(k)) for k in params}


def posterior_mask(params: dict, exclude: Iterable[str] = DEFAULT_EXCLUDE
                   ) -> dict:
    """Mask selecting the parameters in the Laplace posterior."""
    exclude = tuple(exclude)
    return path_mask(params, lambda p: not any(e in p for e in exclude))


def split_by_mask(params: dict, mask: dict) -> tuple[dict, dict]:
    """(selected, rest) dicts with disjoint keys."""
    selected = {k: v for k, v in params.items() if mask[k]}
    rest = {k: v for k, v in params.items() if not mask[k]}
    return selected, rest


def merge_split(selected: dict, rest: dict) -> dict:
    """Inverse of :func:`split_by_mask`."""
    return {**rest, **selected}


def tree_vector(params: dict) -> torch.Tensor:
    """All leaves flattened into one vector in JAX tree order (the analog of
    ``parameters_to_vector``)."""
    leaves = [v for _, v in named_leaves(params) if v is not None]
    return torch.cat([v.reshape(-1) for v in leaves])


def tree_size(params: dict) -> int:
    return sum(int(v.numel()) for v in params.values() if v is not None)


def _flatten_numpy(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_numpy(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_numpy(v, f"{prefix}{i}.", out)
    elif tree is not None:
        out[prefix[:-1]] = tree


def params_from_numpy(tree, device: Optional[str] = None, dtype=None
                      ) -> dict:
    """JAX params pytree (nested dicts and lists of arrays) -> the port's
    flat ``{name: tensor}`` dict on ``device`` (``cuda`` unless asked)."""
    dev = resolve_device(device)
    flat: dict = {}
    _flatten_numpy(tree, "", flat)
    return {k: torch.tensor(np.array(v), dtype=dtype, device=dev)
            for k, v in named_leaves(flat)}


def params_to_numpy(params: dict):
    """The port's flat dict -> nested dicts and lists of numpy arrays, the
    shape of the JAX params pytree."""
    root: dict = {}
    for name, v in named_leaves(params):
        parts = name.split(".")
        node = root
        for p, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(p, {})
        node[parts[-1]] = v.detach().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)
