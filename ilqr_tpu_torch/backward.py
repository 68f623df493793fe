"""Backward Riccati pass: one derivative sweep + a pure-algebra recursion.

Counterpart of ``ilqr_tpu/backward.py``.  Reference structure
(src/backward_pass.jl:324-357): a serial loop that, per timestep, re-runs
autodiff and then does the gain/value algebra.  Here the two are split:

1. all linearizations and cost quadratizations of the horizon come from one
   batched sweep (:mod:`ilqr_tpu_torch.derivatives`);
2. the sequential value recursion is a Python loop over ``t = T-1 … 0``
   (:func:`riccati_scan`), or the hand-written CUDA kernel
   (``backward_backend="pallas"``, through
   :mod:`ilqr_tpu_torch.ops.riccati_dispatch`), or the parallel-in-time
   recursion (``"associative"``, :mod:`ilqr_tpu_torch.pit`).

The per-step algebra replicates the reference exactly:

* Q-function blocks g, G, H — ``optimal_controller_param``,
  src/backward_pass.jl:177-186;
* regularized gain solve (H + reg·I) — ``feedback_parameters``,
  src/backward_pass.jl:207-218 (unrolled Cholesky, ``ops/linalg.py``);
* value recursion (s, s_vec, S) — ``step_back``,
  src/backward_pass.jl:262-273, with the *unregularized* H.

Every function takes optional leading batch axes in front of the JAX
function's shapes (``As [*L, T, n, n]``, per-lane ``reg [*L]``; results
``duffs [*L, T, m]``, ``dV1 [*L]``), the port's written-out ``jax.vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_tpu_torch.config import DEFAULT_CONFIG, ILQRConfig
from ilqr_tpu_torch.derivatives import (problem_dynamics_hessians,
                                        problem_linearize,
                                        problem_quadratize_final,
                                        problem_quadratize_running)
from ilqr_tpu_torch.ops import smallmat as sm
from ilqr_tpu_torch.ops.linalg import solve_psd_small
from ilqr_tpu_torch.ops.riccati_dispatch import make_riccati_op
from ilqr_tpu_torch.precision import highest_precision
from ilqr_tpu_torch.problem import Problem


class BackwardResult(NamedTuple):
    duffs: torch.Tensor  # [*L, T, m] feedforward terms
    Ks: torch.Tensor     # [*L, T, m, n] feedback gains
    dV1: torch.Tensor    # [*L]: sum_t duff_t . g_t   (expected linear decrease)
    dV2: torch.Tensor    # [*L]: sum_t 0.5 duff_t . H_t duff_t


def riccati_step(carry, inp, reg, symmetrize, reg_in_value=False):
    """One backward value-recursion step (pure linear algebra).

    ``carry = (s [*L], s_vec [*L, n], S [*L, n, n])`` is the quadratic
    value model at t+1; ``inp = (A, B, q, qx, ru, Qxx, Pux, Ruu)`` the local
    model at t, with ``Fzz [*L, n, n+m, n+m]`` appended under DDP.

    ``reg_in_value=False`` (default) replicates the reference's mixed
    semantics: gains from H + reg*I, value update with the raw H
    (src/backward_pass.jl:207-218 vs :262-273).  ``True`` uses H + reg*I in
    both — an exact Riccati recursion.
    """

    s, s_vec, S = carry
    if len(inp) == 9:
        # DDP: contract the second-order dynamics tensor with the value
        # gradient at t+1 and fold it into the cost curvature blocks
        # (framework extension — the reference is pure iLQR).
        A, B, q, qx, ru, Qxx, Pux, Ruu, Fzz = inp
        n = A.shape[-1]
        Vf = torch.sum(s_vec[..., :, None, None] * Fzz, dim=-3)
        Qxx = Qxx + Vf[..., :n, :n]
        Pux = Pux + Vf[..., n:, :n]
        Ruu = Ruu + Vf[..., n:, n:]
    else:
        A, B, q, qx, ru, Qxx, Pux, Ruu = inp

    BT_S = sm.mtm(B, S)
    g = ru + sm.mtv(B, s_vec)                 # Qu
    G = Pux + sm.mm(BT_S, A)                  # Qux  [m, n]
    H = Ruu + sm.mm(BT_S, B)                  # Quu  [m, m]

    m = H.shape[-1]
    reg = torch.as_tensor(reg, dtype=H.dtype, device=H.device)
    H_reg = H + reg[..., None, None] * torch.eye(m, dtype=H.dtype,
                                                 device=H.device)
    duff = -solve_psd_small(H_reg, g)
    K = -solve_psd_small(H_reg, G)

    if reg_in_value:
        H = H_reg
    H_duff = sm.mv(H, duff)
    s_new = q + s + 0.5 * sm.vv(duff, H_duff) + sm.vv(duff, g)
    s_vec_new = (qx + sm.mtv(A, s_vec) + sm.mtv(K, H_duff) + sm.mtv(K, g)
                 + sm.mtv(G, duff))
    KtG = sm.mtm(K, G)
    S_new = (Qxx + sm.mtm(A, sm.mm(S, A)) + sm.mtm(K, sm.mm(H, K))
             + KtG + KtG.transpose(-1, -2))
    if symmetrize:
        S_new = 0.5 * (S_new + S_new.transpose(-1, -2))

    out = (duff, K, sm.vv(duff, g), 0.5 * sm.vv(duff, H_duff))
    return (s_new, s_vec_new, S_new), out


@highest_precision
def riccati_scan(As, Bs, q, qx, ru, Qxx, Pux, Ruu, qN, qxN, QN,
                 reg, symmetrize=True, unroll=1, reg_in_value=False,
                 Fzz=None):
    """Whole-horizon backward recursion over precomputed local models.

    Inputs are time-major after the leading axes (``[*L, T, ...]``); the
    loop runs t = T-1 … 0 seeded from the terminal quadratization
    (src/backward_pass.jl:335-336).  ``unroll`` is accepted for the JAX
    signature and ignored.  Returns :class:`BackwardResult`.
    """

    T = As.shape[-3]
    carry = (qN, qxN, QN)
    outs = [None] * T
    for t in reversed(range(T)):
        inp = (As[..., t, :, :], Bs[..., t, :, :], q[..., t], qx[..., t, :],
               ru[..., t, :], Qxx[..., t, :, :], Pux[..., t, :, :],
               Ruu[..., t, :, :])
        if Fzz is not None:
            inp = inp + (Fzz[..., t, :, :, :],)
        carry, outs[t] = riccati_step(carry, inp, reg, symmetrize,
                                      reg_in_value)
    duffs, Ks, dv1, dv2 = zip(*outs)
    return BackwardResult(torch.stack(duffs, dim=-2), torch.stack(Ks, dim=-3),
                          torch.sum(torch.stack(dv1, dim=-1), dim=-1),
                          torch.sum(torch.stack(dv2, dim=-1), dim=-1))


@highest_precision
def backward_pass(problem: Problem, xs: torch.Tensor, us: torch.Tensor,
                  config: ILQRConfig = DEFAULT_CONFIG,
                  reg=None) -> BackwardResult:
    """Feedforward terms and feedback gains for a trajectory ``xs [*L,
    T+1, n]``, ``us [*L, T, m]``.

    Drop-in equivalent of the reference's public ``backward_pass(x, u, f,
    L, Phi)`` (src/backward_pass.jl:324).  The backward pass quadratizes the
    *raw* (un-offset) running cost, as the reference does
    (src/backward_pass.jl:341), while the rollout costs the offset one.

    ``reg`` (scalar or ``[*L]``) defaults to the static ``config.reg``.
    ``backward_backend``: ``"scan"`` (:func:`riccati_scan`, with ``ddp``
    and ``reg_in_value``), ``"pallas"`` (the batching-aware op of
    :mod:`ilqr_tpu_torch.ops.riccati_dispatch`) or ``"associative"`` (the
    parallel-in-time recursion, :mod:`ilqr_tpu_torch.pit`, with
    ``reg_in_value``).
    """

    if reg is None:
        reg = config.reg
    if config.backward_backend not in ("scan", "pallas", "associative"):
        raise NotImplementedError(
            f"backward_backend={config.backward_backend!r} is not ported; "
            "ilqr_tpu_torch has 'scan', 'pallas' (the CUDA kernel) and "
            "'associative'")

    xs_run, x_final = xs[..., :-1, :], xs[..., -1, :]
    As, Bs = problem_linearize(problem, xs_run, us)
    q, qx, ru, Qxx, Pux, Ruu = problem_quadratize_running(problem, xs_run, us)
    qN, qxN, QN = problem_quadratize_final(problem, x_final)

    if config.backward_backend == "associative":
        from ilqr_tpu_torch.pit import riccati_associative_scan

        return riccati_associative_scan(
            As, Bs, q, qx, ru, Qxx, Pux, Ruu, qN, qxN, QN,
            reg=reg, symmetrize=config.symmetrize,
            reg_in_value=config.reg_in_value)
    if config.backward_backend == "pallas":
        op = make_riccati_op(config.symmetrize)
        return BackwardResult(*op(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN,
                                  reg))
    Fzz = None
    if config.ddp:
        Fzz = problem_dynamics_hessians(problem, xs_run, us)
    return riccati_scan(
        As, Bs, q, qx, ru, Qxx, Pux, Ruu, qN, qxN, QN,
        reg=reg, symmetrize=config.symmetrize, unroll=config.scan_unroll,
        reg_in_value=config.reg_in_value, Fzz=Fzz,
    )
