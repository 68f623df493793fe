"""Rotation charts: quaternions, MRPs, and their kinematics.

Counterpart of ``ilqr_tpu/models/rbd/rotations.py``.  Quaternions are
scalar-first ``[w, x, y, z]`` unit quaternions; MRPs (modified Rodrigues
parameters) are the 3-vector chart ``p = q_vec / (1 + q_w)`` the reference
uses as the floating base's attitude state for iLQR (a quaternion is
4-dimensional with a unit constraint; iLQR needs an unconstrained chart).

Every function takes any number of LEADING batch dims: a vector is
``[..., 3]``, a matrix ``[..., 3, 3]``.  Written that way the whole rigid
body layer runs a scenario batch as batched matrix products, with no
``torch.func.vmap`` over scenarios (and so none of the float64 widening
that a per-scenario ``0-d tensor * Python float`` suffers there).

The ``*_jac`` functions are closed-form Jacobians of the small chart maps,
which the JAX package takes with ``jacfwd``; the explicit derivative sweep
of the model uses them.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def linear_map(fn, n_in: int, dtype, device):
    """The matrix ``[n_in, r * c]`` of a LINEAR matrix-valued function
    ``fn(v [n_in]) -> [r, c]`` (``skew``, ``crm``, ...): row ``k`` is
    ``fn(e_k)`` flattened, so ``fn(v) == (v @ W).reshape(r, c)`` — one
    product over any batch instead of a dozen slices, negations and stacks,
    each of which is a kernel launch on a card.  Exact: every entry of the
    result is one ``±v_k`` plus exact zeros."""

    rows = [fn(e).reshape(-1) for e in torch.eye(n_in, dtype=torch.float64)]
    return torch.stack(rows).to(device=device, dtype=dtype)


def _mat(rows):
    """``[..., r, c]`` from nested lists of ``[...]`` tensors."""

    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _skew_entries(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return _mat([[o, -z, y], [z, o, -x], [-y, x, o]])


def skew(v):
    """Cross-product matrix: ``skew(v) @ w == v × w``."""

    W = linear_map(_skew_entries, 3, v.dtype, v.device)
    return (v @ W).reshape(v.shape[:-1] + (3, 3))


def quat_multiply(q1, q2):
    """Hamilton product, scalar-first."""

    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return torch.cat([w, v], dim=-1)


def quat_to_rotmat(q):
    """Rotation matrix R such that ``R @ v_body = v_world`` for the active
    rotation represented by unit quaternion q (scalar-first)."""

    # Entry by entry this is [[1 - 2(yy + zz), 2(xy - wz), 2(xz + wy)], ...];
    # with S = skew([x, y, z]) the same polynomial is I + 2 (w S + S S)
    # (S S = v vᵀ - |v|² I), for unit and raw quaternions alike.
    S = skew(q[..., 1:])
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return eye + 2.0 * (q[..., :1, None] * S + S @ S)


def quat_to_rotmat_jac(q):
    """``dR[..., k, :, :] = ∂ quat_to_rotmat(q) / ∂ q[k]`` ``[..., 4, 3, 3]``
    of the polynomial above in the RAW coordinates (no projection onto the
    unit sphere), which is what ``jacfwd`` of it gives."""

    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    o = torch.zeros_like(w)
    dw = _mat([[o, -z, y], [z, o, -x], [-y, x, o]])
    dx = _mat([[o, y, z], [y, -2 * x, -w], [z, w, -2 * x]])
    dy = _mat([[-2 * y, x, w], [x, o, z], [-w, z, -2 * y]])
    dz = _mat([[-2 * z, -w, x], [w, -2 * z, y], [x, y, o]])
    return 2 * torch.stack([dw, dx, dy, dz], dim=-3)


def p_from_q(q):
    """MRP from quaternion: ``p = q_vec / (1 + q_w)``
    (Attitude.jl semantics, used at RBD_helper_functions.jl:31)."""

    return q[..., 1:] / (1.0 + q[..., :1])


def q_from_p(p):
    """Quaternion from MRP: ``q = [1 - p·p, 2p] / (1 + p·p)``
    (RBD_helper_functions.jl:40)."""

    pp = torch.sum(p * p, dim=-1, keepdim=True)
    return torch.cat([1.0 - pp, 2.0 * p], dim=-1) / (1.0 + pp)


def q_from_p_jac(p):
    """``∂ q_from_p / ∂ p`` ``[..., 4, 3]``: with ``d = 1 + p·p``,
    ``∂q_w/∂p = -4 p / d²`` and ``∂q_vec/∂p = 2 I / d - 4 p pᵀ / d²``."""

    pp = torch.sum(p * p, dim=-1, keepdim=True)
    d = 1.0 + pp
    row_w = (-4.0 * p / (d * d))[..., None, :]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    outer = p[..., :, None] * p[..., None, :]
    rows_v = 2.0 * eye / d[..., None] - 4.0 * outer / (d * d)[..., None]
    return torch.cat([row_w, rows_v], dim=-2)


def _mrp_B(p):
    pp = torch.sum(p * p, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    outer = p[..., :, None] * p[..., None, :]
    return (1.0 - pp) * eye + 2.0 * skew(p) + 2.0 * outer


def pdot_from_w(p, w):
    """MRP kinematics for body-frame angular velocity ``w``:

        ṗ = 1/4 [(1 - p·p) I + 2 skew(p) + 2 p pᵀ] ω

    Derivation: with q = (s, v), body-frame kinematics ṡ = -1/2 v·ω,
    v̇ = 1/2 (s ω + v × ω); substituting v = (1+s)p and
    s = (1 - p·p)/(1 + p·p) yields the formula.  Matches Attitude.jl's
    ``pdot_from_w`` (RBD_helper_functions.jl:67).
    """

    return (0.25 * _mrp_B(p) @ w[..., None])[..., 0]


def pdot_from_w_jac(p, w):
    """``(∂ṗ/∂p, ∂ṗ/∂ω)`` ``[..., 3, 3]`` each: ``∂ṗ/∂ω = B(p)/4`` and
    ``∂ṗ/∂p = 1/4 [-2 ω pᵀ - 2 skew(ω) + 2 (p·ω) I + 2 p ωᵀ]``."""

    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    pw = torch.sum(p * w, dim=-1)[..., None, None]
    w_pT = w[..., :, None] * p[..., None, :]
    p_wT = p[..., :, None] * w[..., None, :]
    Jp = 0.25 * (-2.0 * w_pT - 2.0 * skew(w) + 2.0 * pw * eye + 2.0 * p_wT)
    return Jp, 0.25 * _mrp_B(p)


def rpy_to_rotmat(rpy):
    """URDF fixed-axis roll-pitch-yaw to rotation matrix: R = Rz(y)Ry(p)Rx(r)."""

    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    one, o = torch.ones_like(r), torch.zeros_like(r)
    Rx = _mat([[one, o, o], [o, cr, -sr], [o, sr, cr]])
    Ry = _mat([[cp, o, sp], [o, one, o], [-sp, o, cp]])
    Rz = _mat([[cy, -sy, o], [sy, cy, o], [o, o, one]])
    return Rz @ Ry @ Rx


def axis_angle_to_rotmat(axis, angle):
    """Rodrigues formula for a unit axis (``axis [..., 3]``, ``angle
    [...]``)."""

    K = skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + s * K + (1.0 - c) * (K @ K)
