"""The port's derivative layer (``ilqr_tpu_torch.derivatives``) against the
JAX package's, float64, CPU, rtol 1e-10.

One horizon ``[T, n]`` and a batch of them ``[B, T, n]`` (the port's
leading batch axis against ``jax.vmap`` of the JAX function), with and
without the 2-link's analytic hooks, through ``vmap`` and through the
trailing-axes path (``Problem.batch_trailing``).  Float32 stays float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ilqr_tpu import derivatives as jd
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.problem import Problem as JaxProblem
from ilqr_tpu_torch import derivatives as td
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.problem import Problem
from tests.torch_parity import assert_close, to_torch

RTOL = 1e-10
ATOL = 1e-12
B, T = 3, 7


def _points(seed, B=B, T=T):
    """``xs [B, T, 4]`` and ``us [B, T, 2]`` around the swing-up's start."""

    rng = np.random.default_rng(seed)
    xs = np.array([0.3, 0.7, 0.2, 0.5]) + 0.3 * rng.standard_normal((B, T, 4))
    return xs, 0.5 * rng.standard_normal((B, T, 2))


def _problems(analytic, batch_trailing):
    tp = dataclasses.replace(
        make_two_link_problem(analytic_cost_derivatives=analytic),
        batch_trailing=batch_trailing)
    return jax_two_link(analytic_cost_derivatives=analytic), tp


def _check(out, ref):
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float64
        assert_close(o, r, RTOL, ATOL)


_sweeps_ref = {}


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("batch_trailing", [True, False],
                         ids=["trailing", "vmap"])
@pytest.mark.parametrize("analytic", [True, False], ids=["hooks", "autodiff"])
def test_problem_sweeps(analytic, batch_trailing, batched):
    jp, tp = _problems(analytic, batch_trailing)
    xs, us = _points(0)
    if not batched:
        xs, us = xs[0], us[0]

    def jax_sweeps(x, u):
        return (jd.problem_linearize(jp, x, u)
                + tuple(jd.problem_quadratize_running(jp, x, u))
                + tuple(jd.problem_quadratize_final(jp, x[-1])))

    # The JAX side does not depend on batch_trailing: computed once.
    key = (analytic, batched)
    if key not in _sweeps_ref:
        _sweeps_ref[key] = jax.jit(
            jax.vmap(jax_sweeps) if batched else jax_sweeps)(
                jnp.asarray(xs), jnp.asarray(us))
    ref = _sweeps_ref[key]
    txs, tus = to_torch(xs), to_torch(us)
    out = (td.problem_linearize(tp, txs, tus)
           + tuple(td.problem_quadratize_running(tp, txs, tus))
           + tuple(td.problem_quadratize_final(tp, txs[..., -1, :])))
    _check(out, ref)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_bare_sweeps(batched):
    """The callable-level functions, on the autodiff path of the costs."""

    jp, tp = _problems(False, False)
    xs, us = _points(1)
    if not batched:
        xs, us = xs[0], us[0]

    def jax_sweeps(x, u):
        return (jd.linearize_dynamics(jp.dynamics, x, u)
                + tuple(jd.quadratize_running_cost(jp.cost, x, u))
                + tuple(jd.quadratize_final_cost(jp.final_cost, x[-1]))
                + (jd.dynamics_hessians(jp.dynamics, x, u),))

    ref = jax.jit(jax.vmap(jax_sweeps) if batched else jax_sweeps)(
        jnp.asarray(xs), jnp.asarray(us))
    txs, tus = to_torch(xs), to_torch(us)
    out = (td.linearize_dynamics(tp.dynamics, txs, tus)
           + tuple(td.quadratize_running_cost(tp.cost, txs, tus))
           + tuple(td.quadratize_final_cost(tp.final_cost, txs[..., -1, :]))
           + (td.dynamics_hessians(tp.dynamics, txs, tus),))
    _check(out, ref)
    Fzz = out[-1]
    assert Fzz.shape == xs.shape[:-1] + (4, 6, 6)
    assert torch.equal(Fzz, Fzz.transpose(-1, -2))


def test_dynamics_hessians_hook_is_used_unsymmetrized():
    """A user ``dynamics_hessians`` is used as given in both packages (the
    autodiff path symmetrizes, the hook is not; ``ROADMAP.md`` C2).  A
    symmetric hook agrees with autodiff; an asymmetric one passes through
    untouched."""

    rng = np.random.default_rng(2)
    skew = rng.standard_normal((4, 6, 6))
    skew = skew - skew.transpose(0, 2, 1)
    jp, tp = _problems(True, True)
    xs, us = _points(3)

    for extra in (0.0, 1e-3):
        def jax_hook(x, u, jp=jp, extra=extra):
            H = jax.jacfwd(jax.jacfwd(
                lambda z: jp.dynamics(z[:4], z[4:])))(jnp.concatenate([x, u]))
            return 0.5 * (H + jnp.swapaxes(H, -1, -2)) + extra * skew

        def torch_hook(x, u, tp=tp, extra=extra):
            H = torch.func.jacfwd(torch.func.jacfwd(
                lambda z: tp.dynamics(z[:4], z[4:])))(torch.cat([x, u]))
            return (0.5 * (H + H.transpose(-1, -2))
                    + extra * torch.as_tensor(skew))

        jhp = dataclasses.replace(jp, dynamics_hessians=jax_hook)
        thp = dataclasses.replace(tp, dynamics_hessians=torch_hook)
        ref = jax.jit(jax.vmap(
            lambda x, u: jd.problem_dynamics_hessians(jhp, x, u)))(
                jnp.asarray(xs), jnp.asarray(us))
        out = td.problem_dynamics_hessians(thp, to_torch(xs), to_torch(us))
        assert_close(out, ref, RTOL, ATOL)
        auto = td.problem_dynamics_hessians(tp, to_torch(xs), to_torch(us))
        if extra == 0.0:
            assert_close(out, auto.numpy(), RTOL, ATOL)
        else:
            assert not torch.allclose(out, out.transpose(-1, -2))


def test_user_jacobian_hook_both_ways():
    """An analytic ``dynamics_jacobians`` is called per scenario under
    ``vmap``, or once on trailing axes where the problem promises them."""

    jp, tp = _problems(True, True)
    jac = torch.func.jacfwd(tp.dynamics, argnums=(0, 1))

    def trailing_jac(x, u):
        return td.jacobians_trailing(tp.dynamics)(x, u)

    xs, us = _points(4)
    ref = jax.jit(jax.vmap(lambda x, u: jd.problem_linearize(jp, x, u)))(
        jnp.asarray(xs), jnp.asarray(us))
    for hook, trailing in ((jac, False), (trailing_jac, True)):
        p = dataclasses.replace(tp, dynamics_jacobians=hook,
                                batch_trailing=trailing)
        _check(td.problem_linearize(p, to_torch(xs), to_torch(us)), ref)


class _RecordDtypes(TorchDispatchMode):
    """The dtype of every tensor an operation produces, 0-d tensors aside
    (forward-mode AD wraps Python scalars as 0-d float64 tensors without
    computing in float64)."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(o, torch.Tensor) and o.is_floating_point()
                    and o.ndim > 0):
                self.seen.add(o.dtype)
        return out


@pytest.mark.parametrize("batch_trailing", [True, False],
                         ids=["trailing", "vmap"])
@pytest.mark.parametrize("analytic", [True, False], ids=["hooks", "autodiff"])
def test_float32_in_float32_out(analytic, batch_trailing):
    """Inside a per-scenario ``vmap`` of forward-mode AD ``0-d float32 *
    Python float`` comes out float64 (``ROADMAP.md`` C4, C8); the float64
    comparisons above cannot see it.  Every output is float32, and on the
    card's configuration — trailing axes and the analytic hooks — no
    float64 tensor is made at all."""

    _, tp = _problems(analytic, batch_trailing)
    xs, us = _points(5)
    txs, tus = to_torch(xs).float(), to_torch(us).float()
    td.problem_linearize(tp, txs, tus)      # constants made once, rounded
    with _RecordDtypes() as rec:
        out = (td.problem_linearize(tp, txs, tus)
               + tuple(td.problem_quadratize_running(tp, txs, tus))
               + tuple(td.problem_quadratize_final(tp, txs[..., -1, :])))
    assert all(o.dtype == torch.float32 for o in out)
    if analytic and batch_trailing:
        assert rec.seen == {torch.float32}, rec.seen
    ref = (td.problem_linearize(tp, txs.double(), tus.double())
           + tuple(td.problem_quadratize_running(tp, txs.double(),
                                                 tus.double()))
           + tuple(td.problem_quadratize_final(tp, txs[..., -1, :].double())))
    for o, r in zip(out, ref):
        assert_close(o.double(), r, 1e-5, 1e-5)


def test_generic_problem_without_trailing_axes():
    """A user problem written for one scenario only (no trailing batch
    axes, no hooks), with a Python-float constant in its dynamics."""

    def jdyn(x, u):
        return x + 0.1 * jnp.concatenate([x[2:], jnp.sin(x[:2]) + u])

    def tdyn(x, u):
        return x + 0.1 * torch.cat([x[2:], torch.sin(x[:2]) + u])

    def jcost(x, u):
        return jnp.sum(x ** 4) + jnp.sum(u ** 2) * x[0] ** 2

    def tcost(x, u):
        return torch.sum(x ** 4) + torch.sum(u ** 2) * x[0] ** 2

    jp = JaxProblem(dynamics=jdyn, cost=jcost,
                    final_cost=lambda x: jnp.sum(jnp.cos(x)))
    tp = Problem(dynamics=tdyn, cost=tcost,
                 final_cost=lambda x: torch.sum(torch.cos(x)))
    xs, us = _points(6)

    def jax_sweeps(x, u):
        return (jd.problem_linearize(jp, x, u)
                + tuple(jd.problem_quadratize_running(jp, x, u))
                + tuple(jd.problem_quadratize_final(jp, x[-1]))
                + (jd.problem_dynamics_hessians(jp, x, u),))

    ref = jax.jit(jax.vmap(jax_sweeps))(jnp.asarray(xs), jnp.asarray(us))
    txs, tus = to_torch(xs), to_torch(us)
    out = (td.problem_linearize(tp, txs, tus)
           + tuple(td.problem_quadratize_running(tp, txs, tus))
           + tuple(td.problem_quadratize_final(tp, txs[..., -1, :]))
           + (td.problem_dynamics_hessians(tp, txs, tus),))
    _check(out, ref)
