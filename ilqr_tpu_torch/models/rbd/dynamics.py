"""CRBA mass matrix + RNEA bias forces over a static kinematic tree.

Counterpart of the MATRIX forms of ``ilqr_tpu/models/rbd/dynamics.py``:
differentiable replacements for the two RigidBodyDynamics.jl calls the
reference's model makes per dynamics evaluation — ``mass_matrix(state)``
and ``dynamics_bias(state)`` (RBD_helper_functions.jl:61-66) — as the
Composite Rigid Body Algorithm and the Recursive Newton-Euler Algorithm
(Featherstone, "Rigid Body Dynamics Algorithms", ch. 5-6), and the explicit
derivative sweep of Carpentier & Mansard.  (The JAX package also carries
scalar-expanded copies of these algorithms for its compiler; they compute
the same values and are not ported.)

Every function takes any number of LEADING batch dims (``q [..., nq]``,
``v [..., nv]``): the tree loops unroll in Python over the static tree, and
each matrix product is one batched product over the scenario batch.
Matrices are assembled with ``cat``/``stack``/``pad`` — nothing is written
in place, so everything is safe under ``torch.func.jvp``/``vmap``.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch
from torch.nn.functional import pad

from ilqr_tpu_torch.models.rbd.kinematics import joint_pose, joint_tensors
from ilqr_tpu_torch.models.rbd.rotations import quat_to_rotmat_jac, skew
from ilqr_tpu_torch.models.rbd.spatial import (
    block,
    crf,
    crf_bar as _crf_bar,
    crm,
    mv,
    spatial_inertia,
    xform_from_pose,
)
from ilqr_tpu_torch.models.rbd.urdf import Mechanism
from ilqr_tpu_torch.ops.linalg import (
    cholesky_small,
    solve_psd_small,
    solve_tri_lower,
    solve_tri_upper,
)


class MechTensors(NamedTuple):
    """The fixed tensors of a mechanism on one device in one dtype: each
    joint's motion subspace ``S [6, dof]``, each link's spatial inertia
    ``[6, 6]``, and gravity as a fictitious base acceleration ``[6]``."""

    S: Tuple[torch.Tensor, ...]
    inertia: Tuple[torch.Tensor, ...]
    a_grav: torch.Tensor


def _motion_subspace(joint) -> torch.Tensor:
    axis = torch.tensor(joint.axis, dtype=torch.float64)
    zero = torch.zeros(3, dtype=torch.float64)
    if joint.joint_type in ("revolute", "continuous"):
        return torch.cat([axis, zero])[:, None]
    if joint.joint_type == "prismatic":
        return torch.cat([zero, axis])[:, None]
    if joint.joint_type == "fixed":
        return torch.zeros((6, 0), dtype=torch.float64)
    if joint.joint_type == "floating":
        # Velocity [ω; v] in child (body) coordinates — RigidBodyDynamics.jl
        # QuaternionFloating convention.
        return torch.eye(6, dtype=torch.float64)
    raise ValueError(f"unsupported joint type {joint.joint_type}")


@functools.lru_cache(maxsize=None)
def mech_tensors(mech: Mechanism, dtype, device) -> MechTensors:
    f64 = functools.partial(torch.tensor, dtype=torch.float64)
    S = [_motion_subspace(j) for j in mech.joints]
    inertia = [spatial_inertia(f64(link.mass), f64(link.inertia),
                               f64(link.com)) for link in mech.links]
    # Gravity enters as a fictitious base acceleration -g (world frame).
    a_grav = torch.cat([torch.zeros(3, dtype=torch.float64),
                        -f64(mech.gravity)])

    def to(x):
        return x.to(device=device, dtype=dtype)

    return MechTensors(tuple(map(to, S)), tuple(map(to, inertia)), to(a_grav))


def _joint_X_and_S(joint, q):
    """Child-frame-from-parent-frame motion transform and motion subspace.

    Returns ``(X_up [..., 6, 6], S [6, dof])`` where ``X_up`` maps motion
    vectors from the parent link frame into the child link frame at
    configuration ``q`` (the joint's slice of the global configuration
    vector).
    """

    R, p = joint_pose(joint, q)
    return (xform_from_pose(R, p),
            _motion_subspace(joint).to(device=q.device, dtype=q.dtype))


def _tree_quantities(mech: Mechanism, q):
    """Per-body (X_up, S) along the tree."""

    Ss = mech_tensors(mech, q.dtype, q.device).S
    Xups: List = []
    for i, joint in enumerate(mech.joints):
        lo, hi = mech.q_slices[i]
        Xups.append(xform_from_pose(*joint_pose(joint, q[..., lo:hi])))
    return Xups, Ss


def _body_inertias(mech: Mechanism, like):
    return mech_tensors(mech, like.dtype, like.device).inertia


def _T(A):
    return A.transpose(-1, -2)


def _joint_vector(S, x, lo, hi, like):
    """``S @ x[lo:hi]`` (the joint's spatial velocity or acceleration), or
    zero for a joint with no freedom.  A floating joint's ``S`` is the
    identity and is not multiplied."""

    if hi - lo == 6:
        return x[..., lo:hi]
    if hi > lo:
        return mv(S, x[..., lo:hi])
    return torch.zeros(6, dtype=like.dtype, device=like.device)


def _assemble_tau(mech: Mechanism, Ss, fs, Xups):
    """The backward sweep of RNEA: project each body's force on its joint
    and hand it to the parent.  Returns ``tau [..., nv]`` (``fs`` is
    consumed)."""

    parts = {}
    for i in range(mech.n_bodies - 1, -1, -1):
        lo, hi = mech.v_slices[i]
        if hi > lo:
            parts[i] = fs[i] if hi - lo == 6 else mv(_T(Ss[i]), fs[i])
        p = mech.parents[i]
        if p >= 0:
            fs[p] = fs[p] + mv(_T(Xups[i]), fs[i])
    batch = torch.broadcast_shapes(*(t.shape[:-1] for t in parts.values()))
    return torch.cat([parts[i].expand(batch + parts[i].shape[-1:])
                      for i in sorted(parts)], dim=-1)


def crba_mass_matrix(mech: Mechanism, q, tree=None):
    """Joint-space mass matrix ``M(q) [..., nv, nv]`` (Composite Rigid Body
    Algorithm; equivalent of RigidBodyDynamics.jl ``mass_matrix``).

    ``tree``: the ``(Xups, Ss)`` of :func:`_tree_quantities` at ``q`` where
    the caller has them already (the same for the functions below)."""

    Xups, Ss = tree or _tree_quantities(mech, q)
    Ic = list(_body_inertias(mech, q))

    n = mech.n_bodies
    # Accumulate composite inertias root-ward.
    for i in range(n - 1, -1, -1):
        p = mech.parents[i]
        if p >= 0:
            Ic[p] = Ic[p] + _T(Xups[i]) @ Ic[i] @ Xups[i]

    H = [[None] * n for _ in range(n)]
    for i in range(n):
        Si = Ss[i]
        if Si.shape[1] == 0:
            continue
        F = Ic[i] @ Si
        H[i][i] = _T(Si) @ F
        j = i
        while mech.parents[j] >= 0:
            F = _T(Xups[j]) @ F
            j = mech.parents[j]
            Sj = Ss[j]
            if Sj.shape[1] > 0:
                H[i][j] = _T(F) @ Sj
                H[j][i] = _T(H[i][j])

    moving = [i for i in range(n) if Ss[i].shape[1] > 0]
    rows = []
    for i in moving:
        row = []
        for j in moving:
            if H[i][j] is None:
                H[i][j] = torch.zeros((Ss[i].shape[1], Ss[j].shape[1]),
                                      dtype=q.dtype, device=q.device)
            row.append(H[i][j])
        rows.append(row)
    # A tree whose inertia does not move with q (one sliding body, say)
    # gives an unbatched M; it takes q's batch dims all the same.
    M = block(rows)
    return M.expand(q.shape[:-1] + M.shape[-2:])


def rnea_bias(mech: Mechanism, q, v, tree=None):
    """Bias forces ``C(q, v) v + g(q) [..., nv]`` — the generalized forces
    needed to produce zero acceleration (RNEA with q̈ = 0; equivalent of
    RigidBodyDynamics.jl ``dynamics_bias``)."""

    Xups, Ss = tree or _tree_quantities(mech, q)
    consts = mech_tensors(mech, q.dtype, q.device)
    Is = consts.inertia
    n = mech.n_bodies

    vs: List = [None] * n
    avp: List = [None] * n
    fs: List = [None] * n
    for i in range(n):
        p = mech.parents[i]
        lo, hi = mech.v_slices[i]
        vJ = _joint_vector(Ss[i], v, lo, hi, q)
        if p < 0:
            vs[i] = vJ
            avp[i] = mv(Xups[i], consts.a_grav)
        else:
            vs[i] = mv(Xups[i], vs[p]) + vJ
            avp[i] = mv(Xups[i], avp[p]) + mv(crm(vs[i]), vJ)
        fs[i] = mv(Is[i], avp[i]) + mv(crf(vs[i]), mv(Is[i], vs[i]))

    return _assemble_tau(mech, Ss, fs, Xups)


def rnea_inverse_dynamics(mech: Mechanism, q, v, a, tree=None):
    """Full inverse dynamics ``tau = M(q) a + C(q, v) v + g(q) [..., nv]`` —
    RNEA with nonzero joint accelerations (Featherstone ch. 5; generalizes
    :func:`rnea_bias`, which is the ``a = 0`` special case).

    Built from the same ``Xup``/``S``/inertia quantities as the CRBA mass
    matrix, so the identity ``rnea_inverse_dynamics(q, v, a) ==
    crba_mass_matrix(q) @ a + rnea_bias(q, v)`` holds exactly for ANY raw
    coordinate vector ``q`` (unit quaternion or not) — the property the
    analytic forward-dynamics derivative rule below relies on.
    """

    Xups, Ss = tree or _tree_quantities(mech, q)
    consts = mech_tensors(mech, q.dtype, q.device)
    Is = consts.inertia
    n = mech.n_bodies

    vs: List = [None] * n
    as_: List = [None] * n
    fs: List = [None] * n
    for i in range(n):
        p = mech.parents[i]
        lo, hi = mech.v_slices[i]
        vJ = _joint_vector(Ss[i], v, lo, hi, q)
        aJ = _joint_vector(Ss[i], a, lo, hi, q)
        if p < 0:
            vs[i] = vJ
            as_[i] = mv(Xups[i], consts.a_grav) + aJ
        else:
            vs[i] = mv(Xups[i], vs[p]) + vJ
            as_[i] = mv(Xups[i], as_[p]) + aJ + mv(crm(vs[i]), vJ)
        fs[i] = mv(Is[i], as_[i]) + mv(crf(vs[i]), mv(Is[i], vs[i]))

    return _assemble_tau(mech, Ss, fs, Xups)


def forward_dynamics(mech: Mechanism, q, v, tau):
    """``v̇ = M(q)^{-1} (tau - bias(q, v))`` via CRBA + RNEA + the unrolled
    SPD solve (the reference's ``v̇ = M \\ (-dynamics_bias + u)``,
    RBD_helper_functions.jl:65)."""

    tree = _tree_quantities(mech, q)
    M = crba_mass_matrix(mech, q, tree)
    bias = rnea_bias(mech, q, v, tree)
    return solve_psd_small(M, tau - bias)


def _joint_dX(joint, qj):
    """``∂Xup/∂q_joint`` as a ``[..., 6, 6, dof_q]`` tensor, in closed form
    (the JAX package takes ``jacfwd`` of the single joint's transform).

    ``Xup = [[E, 0], [-E skew(p), E]]`` with ``E = Rᵀ``, so along one
    coordinate ``∂Xup = [[∂E, 0], [-(∂E skew(p) + E skew(∂p)), ∂E]]``:

    * revolute: ``R = R_origin (I + sin q K + (1 - cos q) K²)``, so
      ``∂R = R_origin (cos q K + sin q K²)`` and ``∂p = 0``;
    * prismatic: ``∂R = 0``, ``∂p = R_origin axis``;
    * floating: ``∂R/∂quat_k = R_origin ∂R_b/∂quat_k`` (raw coordinates, no
      projection on the unit sphere) with ``∂p = 0``, and for the three
      position coordinates ``∂R = 0``, ``∂p = R_origin e_k``.
    """

    dtype, device = qj.dtype, qj.device
    dof_q = qj.shape[-1]
    if joint.joint_type == "fixed" or dof_q == 0:
        return torch.zeros(qj.shape[:-1] + (6, 6, dof_q), dtype=dtype,
                           device=device)

    c = joint_tensors(joint, dtype, device)
    R, p = joint_pose(joint, qj)
    E = _T(R)
    Z = torch.zeros((3, 3), dtype=dtype, device=device)

    def from_dE(dE):                 # coordinates that move R only
        return block([[dE, Z], [-dE @ skew(p), dE]])

    def from_dp(dp):                 # coordinates that move p only
        return block([[Z, Z], [-E @ skew(dp), Z]])

    if joint.joint_type in ("revolute", "continuous"):
        s = torch.sin(qj[..., 0])[..., None, None]
        co = torch.cos(qj[..., 0])[..., None, None]
        dR = c.R_origin @ (co * c.K + s * c.KK)
        cols = [from_dE(_T(dR))]
    elif joint.joint_type == "prismatic":
        cols = [from_dp(c.R_axis)]
    elif joint.joint_type == "floating":
        dRb = quat_to_rotmat_jac(qj[..., :4])            # [..., 4, 3, 3]
        cols = [from_dE(_T(c.R_origin @ dRb[..., k, :, :])) for k in range(4)]
        cols += [from_dp(c.R_origin[:, k]) for k in range(3)]
    else:
        raise ValueError(f"unsupported joint type {joint.joint_type}")
    batch = torch.broadcast_shapes(*(x.shape[:-2] for x in cols))
    return torch.stack([x.expand(batch + (6, 6)) for x in cols], dim=-1)


def _cols(term, lo, width):
    """``term [..., r, k]`` placed at columns ``lo:lo+k`` of a zero
    ``[..., r, width]`` matrix (the functional form of ``.at[:, lo:hi]``)."""

    return pad(term, (lo, width - lo - term.shape[-1]))


def rnea_derivatives(mech: Mechanism, q, v, a, tree=None):
    """``(tau, ∂tau/∂q [..., nv, nq], ∂tau/∂v [..., nv, nv])`` of
    :func:`rnea_inverse_dynamics` in ONE forward/backward matrix-recursion
    sweep — the explicit analytic inverse-dynamics derivative algorithm of
    Carpentier & Mansard ("Analytical derivatives of rigid body dynamics
    algorithms", RSS 2018), in place of replaying the RNEA JVP over
    nq + nv one-hot tangents.

    The tangent of every per-body quantity is carried as a dense
    ``[6, w]`` matrix over all ``w = nq + nv`` directions at once
    (columns ``0:nq`` are q-directions, ``nq:`` are v-directions), so the
    whole sweep is ~6 small matrix products per body instead of ``w``
    replays of the full recursion.  Configuration enters only through each
    joint's ``Xup(q)`` (every supported joint's motion subspace ``S`` is
    constant in body coordinates — including the floating joint's
    ``S = I``), via the closed-form ``∂Xup/∂q`` of :func:`_joint_dX`.
    Exactly the derivative of the coded :func:`rnea_inverse_dynamics` (same
    root special case, raw-coordinate quaternion — no chart projection).
    """

    dtype, device = q.dtype, q.device
    Xups, Ss = tree or _tree_quantities(mech, q)
    consts = mech_tensors(mech, dtype, device)
    Is = consts.inertia
    a_grav = consts.a_grav
    n = mech.n_bodies
    nq, nv = mech.nq, mech.nv
    w = nq + nv

    vs: List = [None] * n
    acc: List = [None] * n
    fs: List = [None] * n
    Dv: List = [None] * n
    Da: List = [None] * n
    Df: List = [None] * n
    dXs: List = [None] * n

    def dX_times(dX, vec):
        """``Σ_b dX[a, b, k] vec[b]`` → ``[..., 6, dof_q]``."""

        return torch.einsum("...abk,...b->...ak", dX, vec)

    for i in range(n):
        p = mech.parents[i]
        lo, hi = mech.v_slices[i]
        lq, hq = mech.q_slices[i]
        Si = Ss[i]
        dof = hi - lo
        dX = dXs[i] = _joint_dX(mech.joints[i], q[..., lq:hq])

        vJ = _joint_vector(Si, v, lo, hi, q)
        aJ = _joint_vector(Si, a, lo, hi, q)

        DvJ = (_cols(Si, nq + lo, w) if dof
               else torch.zeros((6, w), dtype=dtype, device=device))

        if p < 0:
            # Root body: v = vJ, a = Xup a_grav + aJ (a fixed ⇒ δaJ = 0).
            vs[i] = vJ
            acc[i] = mv(Xups[i], a_grav) + aJ
            Dv[i] = DvJ
            if hq > lq:
                Da[i] = _cols(dX_times(dX, a_grav), lq, w)
            else:
                Da[i] = torch.zeros((6, w), dtype=dtype, device=device)
        else:
            vs[i] = mv(Xups[i], vs[p]) + vJ
            acc[i] = mv(Xups[i], acc[p]) + aJ + mv(crm(vs[i]), vJ)
            Dv[i] = Xups[i] @ Dv[p] + DvJ
            if hq > lq:
                Dv[i] = Dv[i] + _cols(dX_times(dX, vs[p]), lq, w)
            # δ(crm(v_i) vJ) = -crm(vJ) δv_i + crm(v_i) S_i δν_i, with
            # δv_i the FULL tangent (incl. this joint's δXup v_p columns).
            Da[i] = Xups[i] @ Da[p] - crm(vJ) @ Dv[i]
            if dof:
                Da[i] = Da[i] + _cols(crm(vs[i]) @ Si, nq + lo, w)
            if hq > lq:
                Da[i] = Da[i] + _cols(dX_times(dX, acc[p]), lq, w)

        Iv = mv(Is[i], vs[i])
        fs[i] = mv(Is[i], acc[i]) + mv(crf(vs[i]), Iv)
        # δf = I δa + crf(δv)(I v) + crf(v) I δv.
        Df[i] = Is[i] @ Da[i] + (_crf_bar(Iv) + crf(vs[i]) @ Is[i]) @ Dv[i]

    Dtau = {}
    for i in range(n - 1, -1, -1):
        lo, hi = mech.v_slices[i]
        lq, hq = mech.q_slices[i]
        if hi > lo:
            Dtau[i] = _T(Ss[i]) @ Df[i]
        p = mech.parents[i]
        if p >= 0:
            Dfp = _T(Xups[i]) @ Df[i]
            if hq > lq:
                # δ(Xupᵀ) f = (δXup)ᵀ f — q-columns of this joint only.
                # (fs[i] is complete here: the children came first.)
                Dfp = Dfp + _cols(
                    torch.einsum("...abk,...a->...bk", dXs[i], fs[i]), lq, w)
            Df[p] = Df[p] + Dfp
            fs[p] = fs[p] + mv(_T(Xups[i]), fs[i])
    # tau from the same completed forces, in joint order.
    tau_parts = [mv(_T(Ss[i]), fs[i]) for i in sorted(Dtau)]
    batch = torch.broadcast_shapes(*(t.shape[:-1] for t in tau_parts))
    tau = torch.cat([t.expand(batch + t.shape[-1:]) for t in tau_parts],
                    dim=-1)
    Dtau = torch.cat([Dtau[i].expand(batch + Dtau[i].shape[-2:])
                      for i in sorted(Dtau)], dim=-2)
    return tau, Dtau[..., :nq], Dtau[..., nq:]


def _chol_solve(L, b):
    return solve_tri_upper(_T(L), solve_tri_lower(L, b))


def forward_dynamics_derivatives(mech: Mechanism, q, v, tau):
    """``(v̇, ∂v̇/∂q [..., nv, nq], ∂v̇/∂v [..., nv, nv], M⁻¹ [..., nv, nv])``
    in one sweep: CRBA + ONE Cholesky + RNEA + the explicit
    :func:`rnea_derivatives`, then the Carpentier-Mansard implicit rule

        ∂v̇/∂z = -M(q)⁻¹ ∂RNEA(q, v, a)/∂z |_{a = v̇}   (z ∈ {q, v})
        ∂v̇/∂tau = M(q)⁻¹

    with every right-hand side solved against the PRIMAL factor.  The
    ``M⁻¹`` return doubles as ``∂v̇/∂tau`` (the reference's control enters
    only as ``tau``, RBD_helper_functions.jl:65)."""

    tree = _tree_quantities(mech, q)
    M = crba_mass_matrix(mech, q, tree)
    L = cholesky_small(M)

    bias = rnea_bias(mech, q, v, tree)
    vdot = _chol_solve(L, tau - bias)
    _, dtau_dq, dtau_dv = rnea_derivatives(mech, q, v, vdot, tree)
    nq, nv = mech.nq, mech.nv
    # One solve over all nq + nv + nv right-hand sides.
    eye = torch.eye(nv, dtype=q.dtype, device=q.device)
    rhs = torch.cat(
        [dtau_dq, dtau_dv, (-eye).expand(dtau_dq.shape[:-2] + (nv, nv))],
        dim=-1)
    sol = _chol_solve(L, rhs)
    dvd_dq = -sol[..., :nq]
    dvd_dv = -sol[..., nq:nq + nv]
    Minv = -sol[..., nq + nv:]
    return vdot, dvd_dq, dvd_dv, Minv


def make_forward_dynamics_analytic_jvp(mech: Mechanism):
    """Forward dynamics with the analytic derivative rule of Carpentier &
    Mansard ("Analytical derivatives of rigid body dynamics algorithms",
    RSS 2018): differentiate the INVERSE dynamics at the computed
    acceleration instead of differentiating CRBA + Cholesky + solve.

    From ``RNEA(q, v, v̇) = tau``, implicit differentiation gives

        ∂v̇/∂z = -M(q)^{-1} · ∂RNEA(q, v, a)/∂z |_{a = v̇}      (z ∈ {q, v})
        ∂v̇/∂tau =  M(q)^{-1}

    so a JVP costs one RNEA-JVP plus one pair of triangular solves against
    the PRIMAL Cholesky factor — no tangent ever propagates through the
    composite-inertia accumulation (the expensive half of CRBA) or the
    factorization.  Under ``vmap`` over basis tangents the primal (CRBA +
    RNEA + Cholesky) is computed once, unbatched, and only the tangent rule
    replicates.

    Returns ``fd(q, v, tau) -> v̇`` — same values as
    :func:`forward_dynamics`, custom forward-mode rule.  The JAX package's
    ``jax.custom_jvp`` becomes a ``torch.autograd.Function`` with a ``jvp``
    (whose RNEA tangent is a nested ``torch.func.jvp`` at the fixed
    acceleration) and a generated ``vmap`` rule.  It has no reverse-mode
    rule, as the JAX function has none.
    """

    class ForwardDynamics(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(q, v, tau):
            tree = _tree_quantities(mech, q)
            L = cholesky_small(crba_mass_matrix(mech, q, tree))
            vdot = _chol_solve(L, tau - rnea_bias(mech, q, v, tree))
            # The factor is an output so that the tangent rule can reuse it.
            return vdot, L

        @staticmethod
        def setup_context(ctx, inputs, output):
            q, v, _tau = inputs
            vdot, L = output
            ctx.save_for_forward(q, v, vdot, L)

        @staticmethod
        def jvp(ctx, dq, dv, dtau):
            q, v, vdot, L = ctx.saved_tensors
            # JVP of inverse dynamics at FIXED a = v̇ (vdot is a constant
            # here, so no tangent flows into the acceleration).
            _, dtau_id = torch.func.jvp(
                lambda q_, v_: rnea_inverse_dynamics(mech, q_, v_, vdot),
                (q, v), (dq, dv))
            # The factor's tangent is never used: callers see only v̇.
            return _chol_solve(L, dtau - dtau_id), torch.zeros_like(L)

    def fd(q, v, tau):
        return ForwardDynamics.apply(q, v, tau)[0]

    return fd
