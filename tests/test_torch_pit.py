"""The port's parallel-in-time Riccati (``ilqr_tpu_torch.pit``,
``backward_backend="associative"``), float64, CPU.

* against the JAX ``pit`` on the same local models (2-link, rolled-out
  iterates), T in {1, 7, 64}, B in {1, 3} scenarios on a leading axis, at
  ``reg`` 0 and 0.3, with and without ``reg_in_value``: rtol 1e-9.  The
  port mirrors the odd/even tree of ``jax.lax.associative_scan``, so the
  two combine the same pairs in the same order;
* against the port's own sequential scan where the two recursions are the
  same mathematics — ``reg=0``, and any reg under ``reg_in_value`` — to
  the JAX package's own bar for that comparison (rtol 1e-7, atol 1e-9,
  ``tests/test_pit.py``); the value functions against a numpy recursion;
(A whole solve with ``"associative"`` against the JAX package's is in
``tests/test_torch_pit_solve.py``.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.pit import riccati_associative_scan as jax_pit
from ilqr_tpu_torch.backward import backward_pass, riccati_scan
from ilqr_tpu_torch.convert import config_from_fields
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.pit import (riccati_associative_scan,
                                value_functions_associative)
from tests.torch_parity import NOMINAL, assert_close, jit_fast, to_torch

torch.set_num_threads(1)


def models(B, T, seed=0):
    """Batch-first local models ``As [B, T, n, n]``, … of the 2-link arm at
    a rolled-out iterate, with zero ``q``, ``qN``, as numpy arrays (made by
    the port's ``derivatives_bl``; both packages get the same numbers)."""

    from ilqr_tpu_torch.batched import derivatives_bl, rollout_bl

    rng = np.random.default_rng(seed)
    x0s = NOMINAL + 0.1 * rng.standard_normal((B, 4))
    us = to_torch(0.5 * rng.standard_normal((T, 2, B)))
    tp = make_two_link_problem()
    xs = rollout_bl(tp, to_torch(x0s.T), us)
    bl = derivatives_bl(tp, xs, us)
    As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN = (np.moveaxis(a.numpy(), -1, 0)
                                              for a in bl)
    return (As, Bs, np.zeros((B, T)), qx, ru, Qxx, Pux, Ruu, np.zeros(B),
            qxN, QN)


@functools.lru_cache(maxsize=None)
def jax_pit_of(T):
    """The JAX ``pit`` of one scenario at horizon T, compiled once; ``reg``
    is an argument."""

    m = [jnp.asarray(a[0]) for a in models(3, T, seed=T)]
    return jit_fast(jax_pit, *m, jnp.float64(0.0))


@functools.lru_cache(maxsize=None)
def jax_reference(T, reg, reg_in_value):
    """The JAX ``pit`` of each of three scenarios, as numpy arrays.  Under
    ``reg_in_value`` the JAX function adds ``reg * I`` to ``Ruu`` and goes
    on at reg 0; the same is done here before the call, so that one
    compile serves both."""

    m = list(models(3, T, seed=T))
    if reg_in_value:
        m[7] = m[7] + reg * np.eye(m[7].shape[-1])
        reg = 0.0
    outs = [jax_pit_of(T)(*(jnp.asarray(a[b]) for a in m), jnp.float64(reg))
            for b in range(3)]
    return tuple(np.stack([np.asarray(o[k]) for o in outs]) for k in range(4))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [1, 7, 64])
@pytest.mark.parametrize("reg,reg_in_value", [(0.0, False), (0.3, False),
                                              (0.3, True)])
def test_against_jax_pit(T, B, reg, reg_in_value):
    m = tuple(a[:B] for a in models(3, T, seed=T))
    res = riccati_associative_scan(*map(to_torch, m), reg=reg,
                                   reg_in_value=reg_in_value)
    ref = jax_reference(T, reg, reg_in_value)
    for name, x, y in zip(("duffs", "Ks", "dV1", "dV2"), res, ref):
        assert_close(x, y[:B], 1e-9, 1e-12, err_msg=name)


@pytest.mark.parametrize("reg,reg_in_value", [(0.0, False), (1e-2, True),
                                              (1.0, True)])
def test_against_the_scan_where_they_agree(reg, reg_in_value):
    m = tuple(map(to_torch, models(3, 64, seed=5)))
    par = riccati_associative_scan(*m, reg=reg, reg_in_value=reg_in_value)
    seq = riccati_scan(*m, reg=reg, reg_in_value=reg_in_value)
    for name, x, y in zip(seq._fields, par, seq):
        torch.testing.assert_close(x, y, rtol=1e-7, atol=1e-9, msg=name)


def test_value_functions_against_a_numpy_recursion():
    m = models(1, 16, seed=1)
    As, Bs, q, qx, ru, Qxx, Pux, Ruu, qN, qxN, QN = (a[0] for a in m)
    S_par, s_par = value_functions_associative(*map(to_torch, (
        As, Bs, q, qx, ru, Qxx, Pux, Ruu, qN, qxN, QN)))
    S, s = QN.copy(), qxN.copy()
    S_seq, s_seq = [S], [s]
    for t in range(As.shape[0] - 1, -1, -1):
        A, B = As[t], Bs[t]
        g = ru[t] + B.T @ s
        G = Pux[t] + B.T @ S @ A
        H = Ruu[t] + B.T @ S @ B
        K = -np.linalg.solve(H, G)
        duff = -np.linalg.solve(H, g)
        s = qx[t] + A.T @ s + K.T @ H @ duff + K.T @ g + G.T @ duff
        S = Qxx[t] + A.T @ S @ A + K.T @ H @ K + K.T @ G + G.T @ K
        S_seq.insert(0, S)
        s_seq.insert(0, s)
    assert_close(S_par, np.stack(S_seq), 1e-8, 1e-10)
    assert_close(s_par, np.stack(s_seq), 1e-8, 1e-10)


def test_backward_pass_dispatches_associative():
    tp = make_two_link_problem()
    rng = np.random.default_rng(2)
    us = to_torch(0.1 * rng.standard_normal((2, 32, 2)))
    x0 = to_torch(NOMINAL + 0.1 * rng.standard_normal((2, 4)))
    from ilqr_tpu_torch.problem import problem_dynamics, rollout
    xs = rollout(lambda x, u: problem_dynamics(tp, x, u), x0, us)
    cfg = config_from_fields(dict(reg=0.0))
    seq = backward_pass(tp, xs, us, cfg)
    par = backward_pass(tp, xs, us, cfg.replace(backward_backend="associative"))
    torch.testing.assert_close(par.Ks, seq.Ks, rtol=1e-7, atol=1e-9)
