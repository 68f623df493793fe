"""Checkpoint / resume for long-running batched or MPC solves.

Counterpart of ``ilqr_tpu/utils/checkpoint.py``, in the same file format,
so that a snapshot written by either package resumes in the other.  The
solver state is a plain tree (dicts, tuples, lists, NamedTuples) of tensors
or numpy arrays, serialized to a numpy ``.npz``.

Format (v2): every leaf is stored under ``path:<keystr>``, its NAMED path
in the tree written as JAX's ``keystr`` writes it — a dict key as
``['name']`` (dict keys in sorted order), a NamedTuple field as ``.field``,
a sequence item as ``[i]`` — e.g. ``{"state": StepState, "n_passes": n}``
flattens to ``['n_passes']``, ``['state'].xs``, …, ``['state'].du_sq``.
``__format__`` holds ``2``.  On load, leaves are matched by name against a
template.  v1 files (``leaf_<i>`` keys) load by position.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, List, Tuple

import numpy as np
import torch

_FORMAT_V2 = 2


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _path_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr, leaf), ...]`` in the order ``jax.tree_util.
    tree_flatten_with_path`` gives them.  ``None`` has no leaves; anything
    that is not a dict, tuple or list is a leaf."""

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _path_leaves(tree[key], f"{prefix}[{key!r}]")]
    if _is_namedtuple(tree):
        return [pair for name, child in zip(tree._fields, tree)
                for pair in _path_leaves(child, f"{prefix}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, child in enumerate(tree)
                for pair in _path_leaves(child, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in flatten order."""

    if like is None:
        return None
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(c, leaves) for c in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(c, leaves) for c in like)
    return next(leaves)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return tuple(leaf.shape), dtype
    arr = np.asarray(leaf)
    return tuple(arr.shape), arr.dtype


def save_solver_state(path: str, state: Any) -> None:
    """Serialize a tree of tensors or arrays (a SolverResult, an MPC carry,
    ``{"state": StepState, "n_passes": n}``) to ``path`` (.npz), leaves
    keyed by their path names.  Tensors are copied to the host."""

    named = _path_leaves(state)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(
        path,
        __format__=np.int64(_FORMAT_V2),
        **{f"path:{key}": _as_numpy(leaf) for key, leaf in named},
    )


def load_solver_state(path: str, like: Any) -> Any:
    """Load a tree saved by :func:`save_solver_state` (or by the JAX
    package's function of the same name).

    ``like`` gives the structure, shapes and dtypes (e.g. a freshly
    initialized state).  Leaves are matched by path name; a missing path,
    an extra path, or a shape or dtype that differs from the template's
    raises ``ValueError`` naming the path.  The leaves come back as numpy
    arrays in ``like``'s structure; the caller moves them to the device.
    v1 files (positional ``leaf_<i>`` keys) go through :func:`_load_v1`.
    """

    data = np.load(path)
    if "__format__" not in data:
        return _load_v1(data, like)

    named_like = _path_leaves(like)
    saved_keys = {k[len("path:"):] for k in data.files if k.startswith("path:")}
    like_keys = [key for key, _ in named_like]
    missing = [k for k in like_keys if k not in saved_keys]
    extra = sorted(saved_keys - set(like_keys))
    if missing or extra:
        raise ValueError(
            "checkpoint pytree paths do not match the template:\n"
            f"  missing from checkpoint: {missing}\n"
            f"  not in template:         {extra}")

    leaves = []
    for key, like_leaf in named_like:
        leaf = data[f"path:{key}"]
        like_shape, like_dtype = _shape_dtype(like_leaf)
        if tuple(leaf.shape) != like_shape or leaf.dtype != like_dtype:
            raise ValueError(
                f"checkpoint leaf {key!r} ({leaf.dtype}{tuple(leaf.shape)}) "
                f"does not match template ({like_dtype}{like_shape})")
        leaves.append(leaf)
    return _unflatten(like, iter(leaves))


def _load_v1(data, like: Any) -> Any:
    """Loader for positional ``leaf_<i>`` files (v1).

    Known divergence from the JAX package: a v1 file may carry
    ``__treedef__``, JAX's ``repr`` of the tree structure, which JAX checks
    against the template's.  That string is JAX's own and cannot be
    computed here, so this loader checks the leaves by position, shape and
    dtype only, and warns whenever ``__treedef__`` is present."""

    like_leaves = [leaf for _, leaf in _path_leaves(like)]
    n = len(like_leaves)
    missing = [i for i in range(n) if f"leaf_{i}" not in data]
    if missing:
        raise ValueError(f"checkpoint is missing leaves {missing} "
                         f"(expected {n} leaves)")

    leaves = []
    for i, like_leaf in enumerate(like_leaves):
        leaf = data[f"leaf_{i}"]
        like_shape, like_dtype = _shape_dtype(like_leaf)
        if tuple(leaf.shape) != like_shape or leaf.dtype != like_dtype:
            raise ValueError(
                f"checkpoint leaf {i} ({leaf.dtype}{tuple(leaf.shape)}) does "
                f"not match template ({like_dtype}{like_shape})")
        leaves.append(leaf)

    if "__treedef__" in data:
        warnings.warn(
            "legacy v1 checkpoint: its tree structure (__treedef__) cannot "
            "be checked by ilqr_tpu_torch; accepting because every leaf "
            "shape and dtype matches by position (re-save to upgrade to "
            "the named-path format)", stacklevel=3)
    return _unflatten(like, iter(leaves))
