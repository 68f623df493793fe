"""Featherstone 6-D spatial algebra (motion vectors ``[ω; v]``, angular
first) on tensors with any number of LEADING batch dims.

Counterpart of ``ilqr_tpu/models/rbd/spatial.py``.  Trees are tiny (a
handful of bodies), so 6x6 transforms are materialized and composed with
ordinary (batched) matrix products, unrolled in Python over the static
tree.
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch.models.rbd.rotations import linear_map, skew


def block(rows):
    """``jnp.block`` for matrices with leading batch dims: ``rows`` is a
    nested list of ``[..., r_i, c_j]`` tensors whose batch dims broadcast."""

    batch = torch.broadcast_shapes(*(b.shape[:-2] for r in rows for b in r))
    return torch.cat(
        [torch.cat([b.expand(batch + b.shape[-2:]) for b in r], dim=-1)
         for r in rows], dim=-2)


def mv(A, x):
    """``A @ x`` for ``A [..., i, k]``, ``x [..., k]`` (batch dims
    broadcast)."""

    return (A @ x[..., None])[..., 0]


def xform(E, r):
    """Motion-vector coordinate transform A→B, where frame B's pose in A is
    rotation ``R = E^T`` and origin ``r`` (Featherstone eq. 2.24):

        X = [[E, 0], [-E skew(r), E]]
    """

    Z = torch.zeros((3, 3), dtype=E.dtype, device=E.device)
    return block([[E, Z], [-E @ skew(r), E]])


def xform_from_pose(R, p):
    """Transform taking motion vectors from frame A into frame B, given
    frame B's pose in A: rotation ``R`` (B axes in A coords) and origin
    ``p`` (B origin in A coords)."""

    return xform(R.transpose(-1, -2), p)


def _crm_entries(v):
    w, vl = v[..., :3], v[..., 3:]
    Z = torch.zeros((3, 3), dtype=v.dtype, device=v.device)
    Sw = skew(w)
    return block([[Sw, Z], [skew(vl), Sw]])


def _crf_entries(v):
    return -_crm_entries(v).transpose(-1, -2)


def _crf_bar_entries(m):
    Sa = skew(m[..., :3])
    Sl = skew(m[..., 3:])
    Z = torch.zeros((3, 3), dtype=m.dtype, device=m.device)
    return block([[-Sa, -Sl], [-Sl, Z]])


def _linear6(entries, v):
    return (v @ linear_map(entries, 6, v.dtype, v.device)).reshape(
        v.shape[:-1] + (6, 6))


def crm(v):
    """Motion cross-product matrix: ``crm(v) @ m = v ×ₘ m``,
    ``[[skew(ω), 0], [skew(v), skew(ω)]]``."""

    return _linear6(_crm_entries, v)


def crf(v):
    """Force cross-product matrix: ``crf(v) = -crm(v)^T``."""

    return _linear6(_crf_entries, v)


def crf_bar(m):
    """The 6x6 matrix ``B(m)`` with ``B(m) @ d == crf(d) @ m`` for all
    ``d`` — the force cross product re-expressed as a linear operator in
    its FIRST argument (used to differentiate ``crf(v) I v`` w.r.t. v).

    With ``crf([w; l]) = [[skew(w), skew(l)], [0, skew(w)]]`` and
    ``skew(a) b = -skew(b) a``:

        crf(d) m = [[-skew(m_ang), -skew(m_lin)], [-skew(m_lin), 0]] d
    """

    return _linear6(_crf_bar_entries, m)


def spatial_inertia(mass, inertia_com, com):
    """6x6 spatial inertia of a body in its link frame.

    ``inertia_com`` is the 3x3 rotational inertia about the COM (link-frame
    axes), ``com`` the COM position in the link frame (Featherstone eq.
    2.63):

        I = [[I_com + m c× c×ᵀ, m c×], [m c×ᵀ, m 1]]
    """

    C = skew(com)
    m = mass
    CT = C.transpose(-1, -2)
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    return block([
        [inertia_com + m * (C @ CT), m * C],
        [m * CT, m * eye],
    ])
