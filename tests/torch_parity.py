"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

One input, made with numpy from a seed, goes through the JAX package
(float64, CPU) and through the PyTorch port (float64, ``device="cpu"``, the
plain versions of its kernels); the outputs are compared as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import torch

# The suite runs under several pytest workers; at these sizes one thread is
# the fastest anyway, and more would take cores from the other workers.
torch.set_num_threads(1)

NOMINAL = np.array([0.3, 0.7, 0.2, 0.5])

# XLA's cheaper CPU code generation, for reference programs that run once,
# so that their compile time is what counts.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jit_fast(fn, *example_args):
    """``fn`` compiled by ``jax.jit`` with :data:`FAST_COMPILE` for the
    shapes and types of ``example_args``."""

    import jax

    return jax.jit(fn).lower(*example_args).compile(
        compiler_options=FAST_COMPILE)


def jit_once(fn, *args):
    """``fn(*args)``, compiled as :func:`jit_fast` compiles it."""

    return jit_fast(fn, *args)(*args)


def to_torch(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, ref, rtol, atol=0.0, err_msg=""):
    """``port`` (torch) against ``ref`` (JAX), same shape and float64."""

    a, b = to_numpy(port), to_numpy(ref)
    assert a.shape == b.shape, (a.shape, b.shape, err_msg)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=err_msg)


def scenarios(B, T, seed, x_noise=0.1, u_noise=0.0):
    """``x0s [B, 4]`` around the swing-up's nominal start, ``us0 [B, T, 2]``."""

    rng = np.random.default_rng(seed)
    x0s = NOMINAL + x_noise * rng.standard_normal((B, 4))
    us0 = u_noise * rng.standard_normal((B, T, 2))
    return x0s, us0


def jax_iterate_bl(jax_problem, x0s, us0):
    """The batch-last iterate ``(xs [T+1,n,B], us [T,m,B])`` of the open-loop
    rollout, as numpy arrays, from the JAX package."""

    from ilqr_tpu.batched import rollout_bl

    us = jnp.moveaxis(jnp.asarray(us0), 0, -1)
    xs = rollout_bl(jax_problem, jnp.asarray(x0s).T, us)
    return np.asarray(xs), np.asarray(us)


def jax_local_models(jax_problem, B, T, seed, u_noise=0.5):
    """The nine arrays of the JAX ``derivatives_bl`` at a rolled-out iterate,
    as numpy arrays."""

    from ilqr_tpu.batched import derivatives_bl

    x0s, us0 = scenarios(B, T, seed, u_noise=u_noise)
    xs, us = jax_iterate_bl(jax_problem, x0s, us0)
    return tuple(np.asarray(a) for a in derivatives_bl(
        jax_problem, jnp.asarray(xs), jnp.asarray(us)))
