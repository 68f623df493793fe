"""The port's floating-base arm model against the JAX package's, float64,
CPU: ``make_rbd_arm_problem`` on the 2-DoF arm.

* ``dynamics`` (RK4), ``cost``, ``final_cost`` against the JAX callables
  (rtol 1e-10: the JAX forward dynamics runs its scalar-expanded algebra,
  the port the matrix forms — same values in another order of operations);
* ``dynamics_jacobians`` — the port's explicit sweep — against forward-mode
  AD of the port's own dynamics (against the JAX forms:
  ``tests/test_torch_rbd_jacobians.py``);
* float32 inputs compute in float32 THROUGHOUT: a dispatch mode records the
  dtype of every tensor produced inside the dynamics, the Jacobians and one
  ``derivatives_bl``, and none may be float64;
* the JVP replay (``explicit_derivatives=False``), the custom
  forward-dynamics JVP and the engine's own forward-mode AD give the same
  Jacobians as the explicit sweep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ilqr_tpu.models.rbd import model as jmodel
from ilqr_tpu_torch import batched as tb
from ilqr_tpu_torch.derivatives import jacobians_trailing
from ilqr_tpu_torch.models.rbd import model as tmodel
from ilqr_tpu_torch.models.rbd.urdf import parse_urdf
from tests.torch_parity import to_numpy, to_torch

torch.set_num_threads(1)

NOMINAL = np.array([0.0, 0.0, 1.0, 0.5, 0.75, 1.0, 0.0, 0.0] + [0.0] * 8)


def states(B, seed, n=16, m=8):
    """Perturbed nominal states with moving joints and bases, and controls."""

    rng = np.random.default_rng(seed)
    x = NOMINAL[:, None] + 0.3 * rng.standard_normal((n, B))
    return x, rng.standard_normal((m, B))


def close(port, ref, rtol, atol=0.0):
    a, b = to_numpy(port), np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("reference_kinematics", [False, True])
def test_dynamics_and_costs(reference_kinematics):
    jp = jmodel.make_rbd_arm_problem(
        reference_kinematics=reference_kinematics)
    tp = tmodel.make_rbd_arm_problem(
        reference_kinematics=reference_kinematics)
    assert (tp.state_dim, tp.control_dim) == (16, 8) and tp.batch_trailing
    x, u = states(3, 0)
    out = tp.dynamics(to_torch(x), to_torch(u))          # [n, B] at once
    for b in range(3):
        close(out[:, b], jp.dynamics(jnp.asarray(x[:, b]),
                                     jnp.asarray(u[:, b])), 1e-10, 1e-13)
    close(tp.dynamics(to_torch(x[:, 0]), to_torch(u[:, 0])), out[:, 0],
          1e-13, 1e-15)                                  # per scenario
    close(tp.cost(to_torch(x), to_torch(u)),
          [jp.cost(jnp.asarray(x[:, b]), jnp.asarray(u[:, b]))
           for b in range(3)], 1e-12)
    close(tp.final_cost(to_torch(x)),
          [jp.final_cost(jnp.asarray(x[:, b])) for b in range(3)], 1e-12)
    # Time as a second trailing axis, as the engine's sweeps pass it.
    x2 = to_torch(np.stack([x, x[:, ::-1]], axis=1))
    u2 = to_torch(np.stack([u, u[:, ::-1]], axis=1))
    close(tp.dynamics(x2, u2)[:, 0], out, 1e-13, 1e-15)
    close(tp.cost(x2, u2)[0], tp.cost(to_torch(x), to_torch(u)), 1e-13)


@pytest.mark.parametrize("reference_kinematics", [False, True])
def test_dynamics_jacobians_against_forward_mode_ad(reference_kinematics):
    """The explicit sweep and the RK4 chain rule against ``jvp`` of the
    port's own dynamics along every basis direction."""

    tp = tmodel.make_rbd_arm_problem(
        reference_kinematics=reference_kinematics)
    x, u = map(to_torch, states(2, 2))
    A, B = tp.dynamics_jacobians(x, u)
    A_ad, B_ad = jacobians_trailing(tp.dynamics)(x, u)
    close(A, A_ad, 1e-9, 1e-11)
    close(B, B_ad, 1e-9, 1e-11)
    # The same through derivatives_bl with the hook taken away.
    import dataclasses
    xs = torch.stack([x, tp.dynamics(x, u)])
    us = u[None]
    with_hook = tb.derivatives_bl(tp, xs, us)
    without = tb.derivatives_bl(
        dataclasses.replace(tp, dynamics_jacobians=None), xs, us)
    for a, b in zip(with_hook, without):
        close(a, b, 1e-9, 1e-11)


class _RecordDtypes(TorchDispatchMode):
    """Collects the dtype of every tensor any operation produces, 0-d
    tensors aside: forward-mode AD wraps each Python scalar of an expression
    as a 0-d float64 tensor (with a zero tangent) without computing anything
    in float64, whereas a per-scenario value widened under ``vmap`` is a
    ``[B]`` tensor underneath and is seen."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(o, torch.Tensor) and o.is_floating_point()
                    and o.ndim > 0):
                self.seen.setdefault(o.dtype, set()).add(str(func))
        return out


@pytest.mark.parametrize("which", ["2dof", "6dof", "2dof_replay",
                                   "2dof_ad_custom_jvp"])
def test_float32_computes_in_float32_throughout(which):
    """No float64 tensor is produced inside the dynamics, the Jacobians or
    one ``derivatives_bl`` (its cost Hessians go through a per-scenario
    ``vmap``, where a Python float times a 0-d float32 tensor would come
    out float64) — not merely a float32 result."""

    if which.startswith("2dof"):
        tp = tmodel.make_rbd_arm_problem(**{
            "2dof": {}, "2dof_replay": dict(explicit_derivatives=False),
            "2dof_ad_custom_jvp": dict(analytic_jacobians=False)}[which])
        nominal = NOMINAL
    else:
        tp = tmodel.make_rbd_arm_problem(
            target_pose=[0, 0, 0, 1, 1, 1] + [0.3] * 6,
            urdf_path=tmodel.SIX_DOF_ARM_URDF)
        nominal = np.array([0.0, 0.0, 1.0] + [0.0] * 21)
    n, m = tp.state_dim, tp.control_dim
    rng = np.random.default_rng(3)
    B, T = 2, 2
    x0 = to_torch(nominal[:, None] + 0.1 * rng.standard_normal((n, B))).float()
    us = to_torch(0.5 * rng.standard_normal((T, m, B))).float()
    # Build the cached constants first: they are made in float64 once and
    # rounded, outside any hot loop.
    tb.derivatives_bl(tp, tb.rollout_bl(tp, x0, us), us)

    with _RecordDtypes() as rec:
        xs = tb.rollout_bl(tp, x0, us)
        if tp.dynamics_jacobians is not None:
            A, Bm = tp.dynamics_jacobians(xs[0], us[0])
        models = tb.derivatives_bl(tp, xs, us)
        A, Bm = models[0][0], models[1][0]
        cost = tb.total_cost_bl(tp, xs, us)
    assert torch.float32 in rec.seen
    assert torch.float64 not in rec.seen, sorted(rec.seen[torch.float64])
    for t in (xs, A, Bm, cost) + tuple(models):
        assert t.dtype == torch.float32
    ref = tb.derivatives_bl(tp, xs.double(), us.double())
    for o, r in zip(models, ref):
        np.testing.assert_allclose(o.double().numpy(), r.numpy(), rtol=2e-4,
                                   atol=2e-4 * float(r.abs().max()))


def test_six_dof_problem_and_mrp_state_maps():
    tp = tmodel.make_rbd_arm_problem(
        target_pose=[0, 0, 0, 1, 1, 1] + [0.3] * 6,
        urdf_path=tmodel.SIX_DOF_ARM_URDF)
    assert (tp.state_dim, tp.control_dim) == (24, 12)
    mech = parse_urdf(tmodel.SIX_DOF_ARM_URDF, floating=True)
    assert (mech.nq, mech.nv) == (13, 12)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 17))
    x[:, :4] /= np.linalg.norm(x[:, :4], axis=1, keepdims=True)
    mrp = tmodel.rbd_to_mrp_state(to_torch(x))
    for b in range(3):
        close(mrp[b], jmodel.rbd_to_mrp_state(jnp.asarray(x[b])), 1e-12)
        close(tmodel.mrp_to_rbd_state(mrp[b]),
              jmodel.mrp_to_rbd_state(jnp.asarray(to_numpy(mrp[b]))), 1e-12)


@pytest.mark.parametrize("which", ["2dof", "6dof"])
def test_replay_and_ad_forms_match_the_explicit_sweep(which):
    """The four ways to the same ``(A, B)``: the explicit sweep, the JVP
    replay (``explicit_derivatives=False``), and the engine's own
    forward-mode AD of the dynamics with and without the custom
    forward-dynamics JVP (``analytic_jacobians=False``)."""

    kw = {} if which == "2dof" else dict(
        target_pose=[0, 0, 0, 1, 1, 1] + [0.3] * 6,
        urdf_path=tmodel.SIX_DOF_ARM_URDF)
    explicit = tmodel.make_rbd_arm_problem(explicit_derivatives=True, **kw)
    n, m = explicit.state_dim, explicit.control_dim
    nominal = NOMINAL if which == "2dof" else np.array(
        [0.0, 0.0, 1.0] + [0.0] * 21)
    rng = np.random.default_rng(5)
    x = to_torch(nominal[:, None, None]
                 + 0.3 * rng.standard_normal((n, 2, 3)))   # [n, T, B]
    u = to_torch(rng.standard_normal((m, 2, 3)))
    A, B = explicit.dynamics_jacobians(x, u)
    assert A.shape == (n, n, 2, 3) and B.shape == (n, m, 2, 3)

    replay = tmodel.make_rbd_arm_problem(explicit_derivatives=False, **kw)
    Ar, Br = replay.dynamics_jacobians(x, u)
    close(Ar, A, 1e-9, 1e-11)
    close(Br, B, 1e-9, 1e-11)
    A1, B1 = replay.dynamics_jacobians(x[:, 0, 0], u[:, 0, 0])  # one scenario
    close(A1, A[..., 0, 0], 1e-9, 1e-11)
    close(B1, B[..., 0, 0], 1e-9, 1e-11)

    for analytic_derivatives in (True, False):
        ad = tmodel.make_rbd_arm_problem(
            analytic_jacobians=False,
            analytic_derivatives=analytic_derivatives, **kw)
        assert ad.dynamics_jacobians is None and ad.batch_trailing
        assert torch.equal(ad.dynamics(x, u), explicit.dynamics(x, u))
        Aa, Ba = jacobians_trailing(ad.dynamics)(x, u)
        close(Aa, A, 1e-9, 1e-11)
        close(Ba, B, 1e-9, 1e-11)


def test_forward_dynamics_custom_jvp():
    """``make_forward_dynamics_analytic_jvp``: the values of
    ``forward_dynamics``, and a forward-mode rule that equals plain AD of
    CRBA + Cholesky + solve, alone and under ``vmap`` over tangents."""

    from ilqr_tpu_torch.models.rbd import dynamics as td

    mech = parse_urdf(tmodel.TWO_DOF_ARM_URDF, floating=True)
    fd = td.make_forward_dynamics_analytic_jvp(mech)
    rng = np.random.default_rng(6)
    q, dq = (to_torch(rng.standard_normal((3, mech.nq))) for _ in range(2))
    v, tau, dv, dtau = (to_torch(rng.standard_normal((3, mech.nv)))
                        for _ in range(4))

    def plain(q_, v_, tau_):
        return td.forward_dynamics(mech, q_, v_, tau_)

    out, dout = torch.func.jvp(fd, (q, v, tau), (dq, dv, dtau))
    ref, dref = torch.func.jvp(plain, (q, v, tau), (dq, dv, dtau))
    assert torch.equal(out, ref) and torch.equal(fd(q, v, tau), ref)
    close(dout, dref, 1e-10, 1e-12)
    tangents = tuple(torch.stack([t, -2.0 * t]) for t in (dq, dv, dtau))
    batched = torch.func.vmap(
        lambda a, b, c: torch.func.jvp(fd, (q, v, tau), (a, b, c))[1])(
            *tangents)
    close(batched[0], dref, 1e-10, 1e-12)
    close(batched[1], -2.0 * dref, 1e-10, 1e-12)


def test_derivatives_bl_through_every_jacobian_form():
    """``derivatives_bl`` of the engine gives the same local models whichever
    form the problem carries, chunked or not."""

    forms = {
        "explicit": dict(),
        "replay": dict(explicit_derivatives=False),
        "ad_custom_jvp": dict(analytic_jacobians=False),
        "ad_plain": dict(analytic_jacobians=False,
                         analytic_derivatives=False),
    }
    tp = tmodel.make_rbd_arm_problem()
    x0, us = map(to_torch, states(2, 7))
    us = torch.stack([us, 0.5 * us, -us, 0.1 * us])          # T = 4
    xs = tb.rollout_bl(tp, x0, us)
    ref = tb.derivatives_bl(tp, xs, us)
    for name, kw in forms.items():
        out = tb.derivatives_bl(tmodel.make_rbd_arm_problem(**kw), xs, us,
                                chunk=2)
        for o, r in zip(out, ref):
            assert o.shape == r.shape and o.is_contiguous()
            close(o, r, 1e-9, 1e-9 * float(r.abs().max()))
