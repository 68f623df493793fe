"""Small-matrix products as multiply-and-sum, not matmul.

iLQR's per-step matrices are n x n with n ~ 4-20.  ``torch.matmul`` on a
batch of such blocks goes to a batched GEMM that is mostly padding, and on
a card it may take the reduced-precision tensor-core path (see
``ilqr_tpu_torch.precision``).  These helpers express the same contractions
as broadcast-multiply + reduce: plain elementwise work over the scenario
batch at full working precision.  Counterpart of ``ilqr_tpu/ops/smallmat.py``.

Shapes follow numpy conventions with arbitrary leading batch dims; the
``_bl`` variants are batch-last.
"""

from __future__ import annotations

import torch


def mm(A, B):
    """``A @ B`` for ``A [..., i, k]``, ``B [..., k, j]``."""

    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def mtm(A, B):
    """``A.T @ B`` for ``A [..., k, i]``, ``B [..., k, j]``."""

    return torch.sum(A[..., :, :, None] * B[..., :, None, :], dim=-3)


def mmt(A, B):
    """``A @ B.T`` for ``A [..., i, k]``, ``B [..., j, k]``."""

    return torch.sum(A[..., :, None, :] * B[..., None, :, :], dim=-1)


def mv(A, x):
    """``A @ x`` for ``A [..., i, k]``, ``x [..., k]``."""

    return torch.sum(A * x[..., None, :], dim=-1)


def mtv(A, x):
    """``A.T @ x`` for ``A [..., k, i]``, ``x [..., k]``."""

    return torch.sum(A * x[..., :, None], dim=-2)


def vv(x, y):
    """Dot product over the last axis."""

    return torch.sum(x * y, dim=-1)


# ---------------------------------------------------------------------------
# Batch-last ("_bl") variants: matrix dims lead, the scenario batch is the
# trailing axis.  This is the production layout: the fastest-moving axis is
# the large batch, so elementwise kernels and the fused Riccati kernel read
# consecutive lanes from consecutive addresses.
# ---------------------------------------------------------------------------

def mm_bl(A, B):
    """``A @ B`` with ``A [i, k, B]``, ``B [k, j, B]`` → ``[i, j, B]``."""

    return torch.sum(A[:, :, None, :] * B[None, :, :, :], dim=1)


def mtm_bl(A, B):
    """``A.T @ B`` with ``A [k, i, B]``, ``B [k, j, B]`` → ``[i, j, B]``."""

    return torch.sum(A[:, :, None, :] * B[:, None, :, :], dim=0)


def mv_bl(A, x):
    """``A @ x`` with ``A [i, k, B]``, ``x [k, B]`` → ``[i, B]``."""

    return torch.sum(A * x[None, :, :], dim=1)


def mtv_bl(A, x):
    """``A.T @ x`` with ``A [k, i, B]``, ``x [k, B]`` → ``[i, B]``."""

    return torch.sum(A * x[:, None, :], dim=0)


def vv_bl(x, y):
    """Dot over the leading axis: ``x [k, B]``, ``y [k, B]`` → ``[B]``."""

    return torch.sum(x * y, dim=0)


def transpose_bl(A):
    """``A.T`` for ``A [i, j, B]``."""

    return torch.swapaxes(A, 0, 1)


def _cholesky_unrolled_bl(A, reg, rsqrt: bool):
    """Unrolled Cholesky–Crout of ``A + reg I``: ``(L [m, m, B], inv_diag
    [m, B])`` with ``inv_diag = 1 / diag(L)``.

    Entry ``(i, j)`` is ``A[i, j] - L[i, 0] L[j, 0] - L[i, 1] L[j, 1] - ...``
    in that order, one rounding a product and a difference, then times the
    pivot's reciprocal; the entries below a pivot go as one vector op a
    term, so that a column costs ``2 j`` ops and not ``2 j (m - j)``."""

    m = A.shape[0]
    cols = []   # column k of L, from its diagonal down: [m - k, B]
    inv_diag = [None] * m
    for j in range(m):
        d = A[j, j, :] + reg
        s = A[j + 1:, j, :]
        for k in range(j):
            c = cols[k][j - k:]   # L[j:, k]
            d = d - c[0] * c[0]
            s = s - c[1:] * c[0]
        if rsqrt:
            inv_d = torch.rsqrt(d)
            diag = d * inv_d
        else:
            diag = torch.sqrt(d)
            inv_d = 1.0 / diag
        inv_diag[j] = inv_d
        cols.append(torch.cat([diag[None], s * inv_d], dim=0))
    L = torch.zeros((m, m) + tuple(cols[0].shape[1:]), dtype=cols[0].dtype,
                    device=A.device)
    for j in range(m):
        L[j:, j] = cols[j]
    return L, torch.stack(inv_diag, dim=0)


def cholesky_bl(A, reg=0.0):
    """Lower Cholesky of ``A + reg I`` for ``A [m, m, B]`` (unrolled):
    ``sqrt`` then divide, as the JAX package's scan backend does."""

    return _cholesky_unrolled_bl(A, reg, rsqrt=False)[0]


def cholesky_rsqrt_bl(A, reg=0.0):
    """As :func:`cholesky_bl`, but with one reciprocal square root and a
    multiply per pivot (``L_jj = s * rsqrt(s)``), as the fused kernels do.
    Returns ``(L, inv_diag [m, B])`` so that :func:`cho_solve_bl` can
    multiply instead of divide.  The two factorizations agree to ~1e-16
    relative in float64 and can differ by an ulp in float32."""

    return _cholesky_unrolled_bl(A, reg, rsqrt=True)


def cho_solve_bl(L, b, inv_diag=None):
    """Solve ``(L L^T) x = b`` with ``L [m, m, B]``; ``b [m, B]`` or
    ``[m, k, B]``.  With ``inv_diag [m, B]`` (from
    :func:`cholesky_rsqrt_bl`) the solve multiplies by the reciprocals
    instead of dividing by the diagonal."""

    m = L.shape[0]
    matrix_rhs = b.ndim == 3

    def lane(x):
        return x[None, :] if matrix_rhs else x

    def over_diag(s, i):
        if inv_diag is None:
            return s / lane(L[i, i])
        return s * lane(inv_diag[i])

    # Forward: once y_i is known it leaves every row below it at once, so
    # row i still subtracts L[i, 0] y_0, L[i, 1] y_1, ... in that order.
    ys = []
    rest = b
    for i in range(m):
        ys.append(over_diag(rest[0], i))
        col = L[i + 1:, i]
        rest = rest[1:] - (col[:, None] if matrix_rhs else col) * ys[i]
    xs = [None] * m
    for i in reversed(range(m)):
        s = ys[i]
        for j in range(i + 1, m):
            s = s - lane(L[j, i]) * xs[j]
        xs[i] = over_diag(s, i)
    return torch.stack(xs, dim=0)


def cho_solve_gains_bl(L, g, G, inv_diag=None):
    """``(-x, -X)`` for ``(L L^T) [x | X] = [g | G]``, ``g [m, B]``,
    ``G [m, n, B]``: :func:`cho_solve_bl` of both in one pass, ``g`` as
    column ``n`` (the same operations on each column as two solves)."""

    X = cho_solve_bl(L, torch.cat([G, g[:, None]], dim=1), inv_diag)
    return -X[:, -1], -X[:, :-1]


def solve_psd_bl(A, b, reg=0.0):
    """Solve ``(A + reg I) x = b`` for SPD ``A [m, m, B]``."""

    return cho_solve_bl(cholesky_bl(A, reg), b)
