"""Batching-aware dispatch for the backward Riccati recursion.

Counterpart of ``ilqr_tpu/ops/riccati_dispatch.py``.  There, ``solve`` is
written per scenario and scaled with ``jax.vmap``, and a ``custom_vmap`` op
bridges it to the fused kernel: called unbatched it runs the plain
``lax.scan`` recursion, vmapped over scenarios its batching rule launches
the kernel's batch-first entry.  The port writes the ``vmap`` out as
leading batch axes, so the op tells the two cases apart by the shape it is
given:

* no leading axis (``As [T, n, n]``) — :func:`ilqr_tpu_torch.backward.
  riccati_scan`, a loop over time.  This is the JAX op's own unbatched
  rule (``tests/test_pallas_riccati.py:86-89`` checks it there), not a
  fall-back: a single scenario never reaches the kernel in either package.
* one or more leading axes (``As [*L, T, n, n]``, one scenario included) —
  flattened into one batch axis for
  :func:`ilqr_tpu_torch.ops.cuda_riccati.riccati_scan_cuda_batched`, which
  launches the CUDA kernel on CUDA tensors and runs its plain version on
  CPU tensors.

Numerics are the same either way (the same algebra; the kernel's ``rsqrt``
against the scan's ``sqrt`` and divide is the only difference, ``ROADMAP.md``
C3).
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch.ops.cuda_riccati import riccati_scan_cuda_batched


def make_riccati_op(symmetrize: bool):
    """``op(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg) -> (duffs, Ks,
    dV1, dV2)`` for a static ``symmetrize``; ``reg`` is a scalar or has the
    leading shape."""

    def riccati_op(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg):
        lead = As.shape[:-3]
        if not lead:
            from ilqr_tpu_torch.backward import riccati_scan

            T = As.shape[0]
            zeros = torch.zeros((T,), dtype=As.dtype, device=As.device)
            res = riccati_scan(As, Bs, zeros, qx, ru, Qxx, Pux, Ruu,
                               zeros[0], qxN, QN, reg=reg,
                               symmetrize=symmetrize)
            return res.duffs, res.Ks, res.dV1, res.dV2

        def flat(x, k):
            return x.reshape((-1,) + x.shape[x.ndim - k:])

        args = (flat(As, 3), flat(Bs, 3), flat(qx, 2), flat(ru, 2),
                flat(Qxx, 3), flat(Pux, 3), flat(Ruu, 3), flat(qxN, 1),
                flat(QN, 2))
        reg_t = torch.as_tensor(reg, dtype=As.dtype, device=As.device)
        reg_b = reg_t.expand(lead).reshape(-1)
        duffs, Ks, dv1, dv2 = riccati_scan_cuda_batched(
            *args, reg=reg_b, symmetrize=symmetrize)
        return (duffs.reshape(lead + duffs.shape[1:]),
                Ks.reshape(lead + Ks.shape[1:]),
                dv1.reshape(lead), dv2.reshape(lead))

    return riccati_op
