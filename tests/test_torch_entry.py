"""The port's entry points (``ilqr_tpu_torch.entry``), as
``tests/test_graft_entry.py`` holds the JAX package's: ``entry()`` runs one
solver iteration on the CPU, and ``dryrun_multichip(2)`` shards a solve over
two Gloo ranks on localhost with the JAX dry run's checks.  The iteration is
also held against the JAX ``__graft_entry__.entry()`` on the same
trajectory in float64, to rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as jax_entry
from ilqr_tpu_torch import entry as port_entry

torch.set_num_threads(1)


def test_entry_runs():
    fn, args = port_entry.entry(device="cpu")
    xs, us, cost = fn(*args)
    assert xs.shape == (33, 4) and us.shape == (32, 2) and cost.shape == ()
    assert xs.shape[0] == us.shape[0] + 1
    assert xs.dtype == us.dtype == torch.float32
    assert bool(torch.isfinite(cost))


def test_entry_matches_jax():
    fn, args = port_entry.entry(device="cpu")
    jax_fn, jax_args = jax_entry.entry()
    for a, j in zip(args, jax_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    got = fn(*(a.double() for a in args))
    want = jax.jit(jax_fn)(*(jnp.asarray(np.asarray(j), jnp.float64)
                             for j in jax_args))
    for name, g, w in zip(("xs", "us", "cost"), got, want):
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_dryrun_multichip_2():
    summaries = port_entry.dryrun_multichip(2, device="cpu", timeout=120)
    assert [s["rank"] for s in summaries] == [0, 1]
    for s in summaries:
        assert s["world_size"] == 2 and s["backend"] == "gloo"
    # The reduced metrics are the same on both ranks.
    assert summaries[0]["n_converged"] == summaries[1]["n_converged"]
    assert summaries[0]["mean_cost"] == summaries[1]["mean_cost"]
