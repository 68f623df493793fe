"""Small-matrix linear algebra, unrolled over the static matrix dimension.

Counterpart of ``ilqr_tpu/ops/linalg.py``.  iLQR state/control dims are tiny
(n, m <= ~24); a library factorization of a batch of such matrices is one
call per matrix size with pivoting and workspace the problem does not need.
Every factorization here is unrolled in Python over the matrix dimension
and batched elementwise over any leading dims ``[..., m, m]``.

The recurrences are those of the JAX functions, element for element and in
the same order of operations, so float64 results agree with them to
rounding.  Where the JAX code spells one scalar recurrence per matrix
entry, this code runs the entries of a column, a trailing block or a row of
right-hand sides as one tensor operation: element ``(i, j)`` still sees
``a_ij - l_i0 l_j0 - l_i1 l_j1 - ...`` in that order, but a factorization is
``O(m)`` tensor operations instead of ``O(m^3)`` — on a card each of them is
a kernel launch.

Nothing here writes in place, so everything is safe under
``torch.func.vmap``/``jvp``.
"""

from __future__ import annotations

import torch


def cholesky_small(A):
    """Lower-Cholesky factor of a PSD matrix ``A [..., m, m]``, unrolled
    Cholesky–Crout (``sqrt``, then one reciprocal per pivot).

    Right-looking: once column ``k`` is known, ``l_ik l_jk`` is subtracted
    from the whole trailing block at once.  Entry ``(i, j)`` thereby sees the
    JAX recurrence's ``a_ij - l_i0 l_j0 - l_i1 l_j1 - ...`` in the same
    order, so the factor is the same to the last bit, in six tensor
    operations a column."""

    m = A.shape[-1]
    cols = []                  # cols[j] = L[..., j:, j:j+1]
    rest = A                   # the trailing block [..., m-j, m-j]
    for j in range(m):
        diag = torch.sqrt(rest[..., :1, :1])
        inv_diag = 1.0 / diag
        col = rest[..., 1:, :1] * inv_diag
        cols.append(torch.cat([diag, col], dim=-2))
        if j + 1 < m:
            rest = rest[..., 1:, 1:] - col * col.transpose(-1, -2)
    return torch.cat(
        [torch.nn.functional.pad(c, (0, 0, j, 0)) for j, c in enumerate(cols)],
        dim=-1)


def _rhs(b, matrix_rhs):
    return b if matrix_rhs else b[..., None]


def solve_tri_lower(L, b):
    """Solve ``L y = b`` with ``L [..., m, m]`` lower triangular, unrolled.

    ``b`` may be ``[..., m]`` or ``[..., m, k]``.
    """

    m = L.shape[-1]
    matrix_rhs = b.ndim == L.ndim
    rest = _rhs(b, matrix_rhs)              # rows i..m-1 still to solve
    ys = []
    for i in range(m):
        y = rest[..., :1, :] / L[..., i, i, None, None]
        ys.append(y)
        if i + 1 < m:
            rest = rest[..., 1:, :] - L[..., i + 1:, i, None] * y
    out = torch.cat(ys, dim=-2)
    return out if matrix_rhs else out[..., 0]


def solve_tri_upper(U, b):
    """Solve ``U y = b`` with ``U [..., m, m]`` upper triangular, unrolled."""

    m = U.shape[-1]
    matrix_rhs = b.ndim == U.ndim
    rest = _rhs(b, matrix_rhs)              # rows 0..i still to solve
    ys = [None] * m
    # Columns are eliminated from the right, so row i subtracts its terms
    # u_ij y_j in descending j where the JAX recurrence subtracts them in
    # ascending j: the one place where the order of a sum differs (by
    # rounding only).
    for i in reversed(range(m)):
        y = rest[..., i:, :] / U[..., i, i, None, None]
        ys[i] = y
        if i > 0:
            rest = rest[..., :i, :] - U[..., :i, i, None] * y
    out = torch.cat(ys, dim=-2)
    return out if matrix_rhs else out[..., 0]


def solve_psd_small(A, b):
    """Solve ``A x = b`` for symmetric positive-definite ``A [..., m, m]``.

    Unrolled Cholesky + two triangular substitutions; ``b`` may be a vector
    ``[..., m]`` or matrix ``[..., m, k]`` right-hand side.
    """

    L = cholesky_small(A)
    y = solve_tri_lower(L, b)
    return solve_tri_upper(L.transpose(-1, -2), y)


def solve_general_small(A, b):
    """Solve ``A x = b`` for a general (non-symmetric) ``A [..., m, m]``,
    unrolled Gaussian elimination with partial pivoting.

    The pivot choice is data-dependent per batch element and realized with
    ``where``-selects instead of row gathers.  ``b`` may be ``[..., m]`` or
    ``[..., m, k]``.
    """

    m = A.shape[-1]
    vector_rhs = b.ndim == A.ndim - 1
    if vector_rhs:
        b = b[..., None]
    rows = [torch.cat([A[..., i, :], b[..., i, :]], dim=-1)
            for i in range(m)]

    for kcol in range(m):
        # Partial pivot: among rows kcol..m-1 pick the largest |A[:, kcol]|.
        if kcol < m - 1:
            mags = torch.stack([torch.abs(rows[i][..., kcol])
                                for i in range(kcol, m)], dim=-1)
            p_rel = torch.argmax(mags, dim=-1)  # [...], 0 => no swap
            pivot_row = rows[kcol]
            for off in range(1, m - kcol):
                sel = (p_rel == off)[..., None]
                pivot_row = torch.where(sel, rows[kcol + off], pivot_row)
            for off in range(1, m - kcol):
                sel = (p_rel == off)[..., None]
                rows[kcol + off] = torch.where(sel, rows[kcol],
                                               rows[kcol + off])
            rows[kcol] = pivot_row
        inv_piv = 1.0 / rows[kcol][..., kcol]
        for i in range(kcol + 1, m):
            factor = rows[i][..., kcol] * inv_piv
            rows[i] = rows[i] - factor[..., None] * rows[kcol]

    # Back substitution on the augmented tail.
    xs = [None] * m
    for i in reversed(range(m)):
        s = rows[i][..., m:]
        for j in range(i + 1, m):
            s = s - rows[i][..., j, None] * xs[j]
        xs[i] = s / rows[i][..., i, None]
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vector_rhs else x


def regularized_pinv(A, reg: float = 1e-5):
    """SVD pseudo-inverse with Tikhonov-regularized singular values.

    Functional equivalent of the reference's (dead) fallback path
    ``regularized_persudo_inverse`` (src/backward_pass.jl:221-233): ``reg``
    is added to the singular values before inversion, and
    ``V diag(1/(s+reg)) U^T`` is returned.  Prefer :func:`solve_psd_small`;
    this exists for conditioning emergencies and API completeness.
    """

    U, s, Vt = torch.linalg.svd(A, full_matrices=False)
    s = torch.clamp(s, min=0.0)
    s_inv = 1.0 / (s + reg)
    return Vt.transpose(-1, -2) @ (s_inv[..., None] * U.transpose(-1, -2))
