"""The port's checkpoint files against the JAX package's: the same keys, so
that a file written by either loads in the other.

* a tree of tensors, numpy arrays, NamedTuples, dicts, lists and tuples
  round-trips, leaves back as numpy in the template's structure;
* the path names are JAX's ``keystr``, key for key and in JAX's order;
* a file written by ``ilqr_tpu.utils.checkpoint.save_solver_state`` loads
  in the port, and one written by the port loads in the JAX package;
* a v1 file (positional ``leaf_<i>`` keys, written with numpy) loads by
  position, and warns when it carries a ``__treedef__`` the port cannot
  check;
* a missing, an extra, a mis-shaped or a mis-typed leaf raises
  ``ValueError`` naming its path.
"""

import jax
import numpy as np
import pytest
import torch

from ilqr_tpu.step import StepState as JaxStepState
from ilqr_tpu.utils import checkpoint as jax_ckpt
from ilqr_tpu_torch.step import StepState
from ilqr_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

B, T = 3, 5


def torch_state(seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    return StepState(
        xs=r(T + 1, 4, B), us=r(T, 2, B), prev_cost=r(B),
        iteration=torch.arange(B, dtype=torch.int32),
        status=torch.full((B,), 1, dtype=torch.int32), reg=r(B), alpha=r(B),
        du_sq=r(B))


def tree(seed=0):
    return {"state": torch_state(seed), "n_passes": np.int64(7),
            "plan": [torch.ones(2, dtype=torch.float32),
                     (np.arange(3, dtype=np.int32), torch.zeros(()))],
            "none": None}


def numpy_tree(t):
    """The same tree with every tensor as a numpy array (what JAX flattens)."""

    if isinstance(t, torch.Tensor):
        return t.numpy()
    if isinstance(t, dict):
        return {k: numpy_tree(v) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(type(t), "_fields"):
        return type(t)(*(numpy_tree(v) for v in t))
    if isinstance(t, (tuple, list)):
        return type(t)(numpy_tree(v) for v in t)
    return t


def assert_tree_equal(loaded, ref):
    if isinstance(ref, (dict, tuple, list)):
        assert type(loaded) is type(ref)
    if isinstance(ref, dict):
        assert list(loaded) == sorted(ref)
        for k in ref:
            assert_tree_equal(loaded[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(loaded) == len(ref)
        for a, b in zip(loaded, ref):
            assert_tree_equal(a, b)
    elif ref is None:
        assert loaded is None
    else:
        ref_np = ref.numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
        assert isinstance(loaded, np.ndarray)
        assert loaded.dtype == ref_np.dtype and loaded.shape == ref_np.shape
        np.testing.assert_array_equal(loaded, ref_np)


def test_round_trip(tmp_path):
    path = str(tmp_path / "state.npz")
    ckpt.save_solver_state(path, tree(0))
    loaded = ckpt.load_solver_state(path, tree(1))
    assert_tree_equal(loaded, tree(0))
    assert isinstance(loaded["state"], StepState)


def test_path_names_are_jax_keystr():
    ref_tree = numpy_tree(tree())
    paths, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    want = [jax.tree_util.keystr(p) for p, _ in paths]
    got = [k for k, _ in ckpt._path_leaves(tree())]
    assert got == want
    assert got[0] == "['n_passes']" and got[-1] == "['state'].du_sq"


def test_jax_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    src = numpy_tree(tree(2))
    src["state"] = JaxStepState(*src["state"])
    jax_ckpt.save_solver_state(path, src)
    loaded = ckpt.load_solver_state(path, tree(3))
    assert_tree_equal(loaded, tree(2))


def test_port_file_loads_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    ckpt.save_solver_state(path, tree(4))
    like = numpy_tree(tree(5))
    like["state"] = JaxStepState(*like["state"])
    loaded = jax_ckpt.load_solver_state(path, like)
    for got, want in zip(jax.tree.leaves(loaded),
                         jax.tree.leaves(numpy_tree(tree(4)))):
        np.testing.assert_array_equal(np.asarray(got), want)
        assert np.asarray(got).dtype == want.dtype


@pytest.mark.parametrize("with_treedef", [False, True])
def test_v1_file_loads_by_position(tmp_path, with_treedef):
    path = str(tmp_path / "v1.npz")
    leaves = [np.asarray(x) for _, x in ckpt._path_leaves(numpy_tree(tree(6)))]
    extra = {"__treedef__": np.frombuffer(b"PyTreeDef(...)", np.uint8)
             } if with_treedef else {}
    np.savez(path, **{f"leaf_{i}": x for i, x in enumerate(leaves)}, **extra)
    if with_treedef:
        with pytest.warns(UserWarning, match="__treedef__"):
            loaded = ckpt.load_solver_state(path, tree(7))
    else:
        loaded = ckpt.load_solver_state(path, tree(7))
    assert_tree_equal(loaded, tree(6))


def test_v1_file_missing_a_leaf_raises(tmp_path):
    path = str(tmp_path / "v1.npz")
    np.savez(path, leaf_0=np.int64(7))
    with pytest.raises(ValueError, match="missing leaves"):
        ckpt.load_solver_state(path, tree())


def _template_missing(t):
    t = dict(t)
    t["extra"] = torch.zeros(2)
    return t, "['extra']"


def _template_extra(t):
    t = dict(t)
    del t["n_passes"]
    return t, "['n_passes']"


def _template_shape(t):
    t = dict(t)
    t["state"] = t["state"]._replace(reg=torch.zeros(B + 1,
                                                      dtype=torch.float64))
    return t, "['state'].reg"


def _template_dtype(t):
    t = dict(t)
    t["state"] = t["state"]._replace(status=torch.zeros(B,
                                                        dtype=torch.int64))
    return t, "['state'].status"


@pytest.mark.parametrize("change", [_template_missing, _template_extra,
                                    _template_shape, _template_dtype],
                         ids=["missing", "extra", "shape", "dtype"])
def test_mismatch_raises_naming_the_path(tmp_path, change):
    path = str(tmp_path / "state.npz")
    ckpt.save_solver_state(path, tree())
    like, name = change(tree())
    with pytest.raises(ValueError) as err:
        ckpt.load_solver_state(path, like)
    assert name in str(err.value)
