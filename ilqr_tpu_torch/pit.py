"""Parallel-in-time Riccati: a log-depth backward pass by associative scan.

Counterpart of ``ilqr_tpu/pit.py`` (``backward_backend="associative"``).
The reference's backward pass is strictly sequential in the horizon
(src/backward_pass.jl:339-351), O(T) depth.  This module writes the
affine-quadratic value recursion as an *associative* operator and runs it
as a scan of O(log T) depth (after Särkkä & García-Fernández, "Temporal
Parallelisation of Dynamic Programming and Linear Quadratic Control",
arXiv:2104.03186).

Each timestep becomes an element ``e_k = (A, b, C, eta, J)`` representing
the conditional value function

    V_k(x, z) = 1/2 x^T J x - eta^T x + D_C(z - A x - b),

with ``D_C(d) = 1/2 d^T C^+ d``.  For the stage cost
``l(x,u) = 1/2 x^T Q x + q^T x + 1/2 u^T R u + r^T u + u^T P x``,
completing the square in u gives

    A_e   = A - B R^{-1} P          b_e = -B R^{-1} r
    C_e   = B R^{-1} B^T            J_e = Q - P^T R^{-1} P
    eta_e = -(q - P^T R^{-1} r)

and the terminal element is ``(0, 0, 0, -q_N, Q_N)``.  The suffix
combinations ``e_k ⊗ … ⊗ e_T`` give ``S_k = J`` and ``s_k = -eta``; the
gains are then recovered pointwise with the sequential formulas
(src/backward_pass.jl:177-218).

torch has no associative scan, so :func:`_associative_scan_reverse` writes
one over the time axis: the odd/even tree of ``jax.lax.associative_scan``,
the same pairs combined in the same order, each level one batched call of
:func:`_combine` over all the pairs of that level.  Mirroring the tree
keeps the rounding of the JAX function, not only its depth.  Leading batch
axes (``As [*L, T, n, n]``, ``reg [*L]``) go through, as everywhere in the
per-scenario port.

Regularization caveat (as in the JAX module): the associative recursion is
the *exact* (reg = 0) Riccati recursion; ``reg`` enters only the gain
extraction, so with ``reg > 0`` it differs from the sequential backend by
O(reg).  ``reg_in_value=True`` folds reg into ``Ruu`` — exactly the
consistent trust-region recursion of ``backward.riccati_step(...,
reg_in_value=True)``, which is associative — and then the two agree to
rounding at any reg.
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch.ops.linalg import solve_general_small, solve_psd_small
from ilqr_tpu_torch.precision import highest_precision


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _combine(ei, ej):
    """Associative combination of value elements (``ei`` earlier, ``ej``
    later), batched over any leading axes."""

    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    n = Ai.shape[-1]
    I = torch.eye(n, dtype=Ai.dtype, device=Ai.device)

    # (I + C_i J_j)^{-1} applied from the left: one pivoted elimination with
    # the right-hand sides in one augmented block.
    ICJ = I + Ci @ Jj
    rhs1 = torch.cat([Ai, Ci, (bi + _mv(Ci, etaj))[..., None]], dim=-1)
    sol1 = solve_general_small(ICJ, rhs1)
    Ai_s = sol1[..., :n]
    Ci_s = sol1[..., n:2 * n]
    bCe_s = sol1[..., 2 * n]

    # Push-through identity: (I + J_j C_i)^{-1} J_j = J_j (I + C_i J_j)^{-1}.
    IJC = I + Jj @ Ci
    rhs2 = torch.cat([Jj, (etaj - _mv(Jj, bi))[..., None]], dim=-1)
    sol2 = solve_general_small(IJC, rhs2)
    Jj_s = sol2[..., :n]
    eJb_s = sol2[..., n]

    AiT = Ai.transpose(-1, -2)
    A = Aj @ Ai_s
    b = _mv(Aj, bCe_s) + bj
    C = Aj @ Ci_s @ Aj.transpose(-1, -2) + Cj
    eta = _mv(AiT, eJb_s) + etai
    J = AiT @ Jj_s @ Ai + Ji
    # Keep the quadratic blocks symmetric against float32 drift.
    C = 0.5 * (C + C.transpose(-1, -2))
    J = 0.5 * (J + J.transpose(-1, -2))
    return (A, b, C, eta, J)


def _interleave(a, b):
    """``[a0, b0, a1, b1, …]`` along axis 0; ``len(a)`` is ``len(b)`` or
    ``len(b) + 1``."""

    nb = b.shape[0]
    pairs = torch.stack([a[:nb], b], dim=1).reshape((2 * nb,) + b.shape[1:])
    return pairs if a.shape[0] == nb else torch.cat([pairs, a[nb:]], dim=0)


def _scan(fn, elems):
    """Inclusive scan of ``fn`` over axis 0 of every tensor of ``elems``,
    by the recursion of ``jax.lax.associative_scan``: combine adjacent
    pairs, scan the half-length sequence (the odd outputs), then combine
    each odd output with the next original element (the even outputs)."""

    num = elems[0].shape[0]
    if num < 2:
        return elems
    reduced = fn(tuple(e[0:num - 1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = _scan(fn, reduced)
    if num % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd),
                  tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _associative_scan_reverse(elems):
    """Suffix combinations ``e_k ⊗ … ⊗ e_T`` for every k, over axis 0:
    ``jax.lax.associative_scan(_combine_reversed, elems, reverse=True)``,
    whose operator receives the later (accumulated suffix) element first."""

    flipped = tuple(torch.flip(e, dims=(0,)) for e in elems)
    out = _scan(lambda later, earlier: _combine(earlier, later), flipped)
    return tuple(torch.flip(e, dims=(0,)) for e in out)


def value_functions_associative(As, Bs, q, qx, ru, Qxx, Pux, Ruu, qN, qxN,
                                QN):
    """All value-function pairs ``(S_k [*L, T+1, n, n], s_k [*L, T+1, n])``
    in O(log T) depth.  Inputs as in
    :func:`ilqr_tpu_torch.backward.riccati_scan`."""

    n = As.shape[-1]
    Rinv_P = solve_psd_small(Ruu, Pux)                      # [*L, T, m, n]
    Rinv_r = solve_psd_small(Ruu, ru)                       # [*L, T, m]
    Rinv_BT = solve_psd_small(Ruu, Bs.transpose(-1, -2))    # [*L, T, m, n]

    A_e = As - Bs @ Rinv_P
    b_e = -_mv(Bs, Rinv_r)
    C_e = Bs @ Rinv_BT
    J_e = Qxx - Pux.transpose(-1, -2) @ Rinv_P
    eta_e = -(qx - _mv(Pux.transpose(-1, -2), Rinv_r))

    # The terminal element appended, then time to axis 0.
    lead = As.shape[:-3]
    zeros_nn = torch.zeros(lead + (1, n, n), dtype=As.dtype, device=As.device)
    zeros_n = torch.zeros(lead + (1, n), dtype=As.dtype, device=As.device)
    elems = (
        torch.cat([A_e, zeros_nn], dim=-3).movedim(-3, 0),
        torch.cat([b_e, zeros_n], dim=-2).movedim(-2, 0),
        torch.cat([C_e, zeros_nn], dim=-3).movedim(-3, 0),
        torch.cat([eta_e, -qxN[..., None, :]], dim=-2).movedim(-2, 0),
        torch.cat([J_e, QN[..., None, :, :]], dim=-3).movedim(-3, 0),
    )
    _, _, _, eta_s, J_s = _associative_scan_reverse(elems)
    S = J_s.movedim(0, -3)                 # [*L, T+1, n, n]
    s_vec = -eta_s.movedim(0, -2)          # [*L, T+1, n]
    return S, s_vec


@highest_precision
def riccati_associative_scan(As, Bs, q, qx, ru, Qxx, Pux, Ruu, qN, qxN, QN,
                             reg, symmetrize=True, reg_in_value=False):
    """Drop-in replacement for :func:`ilqr_tpu_torch.backward.riccati_scan`
    by the parallel-in-time recursion (see the module docstring for the
    regularization caveat).  ``symmetrize`` is accepted for the signature;
    the combine keeps its blocks symmetric.

    With ``reg_in_value=True`` the Tikhonov term is folded into ``Ruu``
    before the elements are built: the local model is in the control
    *correction*, so reg*I in ``Ruu`` is exactly reg/2*|du|^2 in each stage
    cost, and the exact recursion over that cost reproduces the sequential
    consistent-reg recursion at any reg.
    """

    from ilqr_tpu_torch.backward import BackwardResult

    m = Ruu.shape[-1]
    eye = torch.eye(m, dtype=Ruu.dtype, device=Ruu.device)
    reg = torch.as_tensor(reg, dtype=Ruu.dtype, device=Ruu.device)
    reg = reg[..., None, None, None]       # over [*L, T, m, m]
    if reg_in_value:
        Ruu = Ruu + reg * eye
        reg = torch.zeros_like(reg)

    S, s_vec = value_functions_associative(
        As, Bs, q, qx, ru, Qxx, Pux, Ruu, qN, qxN, QN)
    S1 = S[..., 1:, :, :]        # [*L, T, n, n] — value at k+1
    s1 = s_vec[..., 1:, :]       # [*L, T, n]

    # Pointwise gain extraction over every step at once — the algebra of the
    # sequential step (src/backward_pass.jl:177-218).
    BT = Bs.transpose(-1, -2)
    BT_S = BT @ S1
    g = ru + _mv(BT, s1)
    G = Pux + BT_S @ As
    H = Ruu + BT_S @ Bs
    H_reg = H + reg * eye
    duff = -solve_psd_small(H_reg, g)
    K = -solve_psd_small(H_reg, G)
    dv1 = torch.sum(duff * g, dim=-1)
    dv2 = 0.5 * torch.sum(duff * _mv(H, duff), dim=-1)
    return BackwardResult(duff, K, torch.sum(dv1, dim=-1),
                          torch.sum(dv2, dim=-1))
