"""The port's backward pass (``ilqr_tpu_torch.backward``,
``ops/riccati_dispatch.py`` and the batch-first entry of
``ops/cuda_riccati.py``) against the JAX package's, float64, CPU.

``riccati_step``/``riccati_scan`` with ``reg_in_value`` and the DDP ``Fzz``
branch, one scenario and a batch (the port's leading axis against
``jax.vmap``): rtol 1e-10, atol 1e-12, the bar of the JAX package's own
kernel test.  ``backward_pass`` with ``"scan"`` and ``"pallas"``: unbatched
the op runs the scan (the JAX op's own unbatched rule), batched it goes
through the batch-first entry, whose CPU path is the kernel's plain
version; both are held against the JAX scan backend, which the JAX package
ties to its kernel (``tests/test_pallas_riccati.py``), and the entry once
against the Pallas kernel itself in interpret mode at a small size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import backward as jbw
from ilqr_tpu.config import ILQRConfig as JaxConfig
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.ops.pallas_riccati import riccati_scan_pallas_batched
from ilqr_tpu_torch import backward as tbw
from ilqr_tpu_torch.config import ILQRConfig
from ilqr_tpu_torch.models.two_link import make_two_link_problem
from ilqr_tpu_torch.ops import cuda_riccati, riccati_dispatch
from ilqr_tpu_torch.ops.cuda_riccati import (riccati_scan_cuda_batched,
                                             riccati_scan_plain_batched,
                                             riccati_scan_plain_bl,
                                             to_batch_last)
from tests.torch_parity import assert_close, to_torch

RTOL = 1e-10
ATOL = 1e-12


def _models(n, m, B, T, seed):
    """Batch-first local models ``(A, B, q, qx, ru, Qxx, Pux, Ruu, Fzz)``
    with SPD cost blocks and near-identity dynamics, and the terminal
    ``(qN, qxN, QN)``, as numpy arrays."""

    rng = np.random.default_rng(seed)

    def spd(*lead, k):
        R = rng.standard_normal(lead + (k, k))
        return R @ np.swapaxes(R, -1, -2) / k + np.eye(k)

    Fzz = 0.1 * rng.standard_normal((B, T, n, n + m, n + m))
    steps = (np.eye(n) + 0.1 * rng.standard_normal((B, T, n, n)),
             0.5 * rng.standard_normal((B, T, n, m)),
             rng.standard_normal((B, T)), rng.standard_normal((B, T, n)),
             rng.standard_normal((B, T, m)), spd(B, T, k=n),
             0.1 * rng.standard_normal((B, T, m, n)), spd(B, T, k=m),
             0.5 * (Fzz + np.swapaxes(Fzz, -1, -2)))
    final = (rng.standard_normal(B), rng.standard_normal((B, n)),
             spd(B, k=n))
    return steps, final


FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("reg_in_value,ddp", FLAGS,
                         ids=["plain", "reg_in_value", "ddp", "both"])
def test_riccati_step_and_scan(reg_in_value, ddp):
    B, T, n, m = 3, 6, 4, 2
    steps, final = _models(n, m, B, T, seed=1)
    if not ddp:
        steps = steps[:8]
    reg = np.array([1e-2, 0.3, 1.0])

    # One step from the terminal carry, first scenario.
    carry = tuple(f[0] for f in final)
    inp = tuple(a[0, -1] for a in steps)
    jc, jo = jbw.riccati_step(tuple(map(jnp.asarray, carry)),
                              tuple(map(jnp.asarray, inp)), reg[0], True,
                              reg_in_value)
    tc, to = tbw.riccati_step(tuple(map(to_torch, carry)),
                              tuple(map(to_torch, inp)), reg[0], True,
                              reg_in_value)
    for o, r in zip(tc + to, jc + jo):
        assert_close(o, r, RTOL, ATOL)

    def jax_scan(args, fin, r):
        return jbw.riccati_scan(*args[:8], *fin, reg=r, symmetrize=True,
                                reg_in_value=reg_in_value,
                                Fzz=args[8] if ddp else None)

    # The whole horizon, the batch with per-lane reg (jax.vmap) against the
    # port's leading axis, and its first scenario alone.
    ref = jax.jit(jax.vmap(jax_scan))(
        tuple(map(jnp.asarray, steps)), tuple(map(jnp.asarray, final)),
        jnp.asarray(reg))
    for sl, r in ((0, reg[0]), (slice(None), to_torch(reg))):
        t_steps = tuple(to_torch(a[sl]) for a in steps)
        out = tbw.riccati_scan(*t_steps[:8], *(to_torch(f[sl])
                                               for f in final),
                               reg=r, symmetrize=True,
                               reg_in_value=reg_in_value,
                               Fzz=t_steps[8] if ddp else None)
        assert isinstance(out, tbw.BackwardResult)
        for o, rr in zip(out, ref):
            assert_close(o, np.asarray(rr)[sl], RTOL, ATOL)


class _CountBatched:
    """Counts the calls the dispatch makes to the batch-first entry."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return riccati_scan_cuda_batched(*args, **kw)


BACKWARD = {
    "scan": dict(backward_backend="scan"),
    "pallas": dict(backward_backend="pallas"),
    "scan_ddp": dict(backward_backend="scan", ddp=True),
    "scan_reg_in_value": dict(backward_backend="scan", reg_in_value=True),
}


_backward_ref = {}


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("flags", sorted(BACKWARD))
def test_backward_pass(flags, batched, monkeypatch):
    """Local models of the 2-link arm at a rolled-out iterate, then the
    recursion.  The reference is always the JAX scan backend with the same
    ``ddp``/``reg_in_value`` (vmapped for the batch)."""

    B, T = 4, 9
    kw = BACKWARD[flags]
    tcfg = ILQRConfig(**kw)
    jcfg = JaxConfig(**dict(kw, backward_backend="scan"))
    rng = np.random.default_rng(2)
    xs = (np.array([0.3, 0.7, 0.2, 0.5])
          + 0.3 * rng.standard_normal((B, T + 1, 4)))
    us = 0.5 * rng.standard_normal((B, T, 2))
    reg = np.array([1e-2, 0.1, 1.0, 3e-3])
    jp, tp = jax_two_link(), make_two_link_problem()

    def jax_backward(x, u, r):
        return jbw.backward_pass(jp, x, u, jcfg, reg=r)

    # One vmapped reference per flag set, shared by "scan" and "pallas" and
    # by the batch and its first scenario.
    if jcfg not in _backward_ref:
        _backward_ref[jcfg] = [np.asarray(r) for r in jax.jit(
            jax.vmap(jax_backward))(jnp.asarray(xs), jnp.asarray(us),
                                    jnp.asarray(reg))]
    ref = _backward_ref[jcfg]

    counter = _CountBatched()
    monkeypatch.setattr(riccati_dispatch, "riccati_scan_cuda_batched",
                        counter)
    if batched:
        out = tbw.backward_pass(tp, to_torch(xs), to_torch(us), tcfg,
                                reg=to_torch(reg))
    else:
        out = tbw.backward_pass(tp, to_torch(xs[0]), to_torch(us[0]), tcfg,
                                reg=reg[0])
        ref = [r[0] for r in ref]
    for name, o, r in zip(("duffs", "Ks", "dV1", "dV2"), out, ref):
        assert_close(o, r, RTOL, ATOL, err_msg=name)
    # Batched "pallas" goes through the batch-first entry, once a pass;
    # one scenario runs the scan, as the JAX op's unbatched rule does.
    assert counter.calls == int(batched and flags == "pallas")


def test_backward_pass_default_reg_and_float32():
    """``reg=None`` is ``config.reg``; float32 in, float32 out on both
    backends (the batch-first entry keeps the working type)."""

    _, tp = jax_two_link(), make_two_link_problem()
    rng = np.random.default_rng(3)
    xs = to_torch(np.array([0.3, 0.7, 0.2, 0.5])
                  + 0.3 * rng.standard_normal((3, 6, 4))).float()
    us = to_torch(0.5 * rng.standard_normal((3, 5, 2))).float()
    for backend in ("scan", "pallas"):
        cfg = ILQRConfig(backward_backend=backend, reg=0.5)
        a = tbw.backward_pass(tp, xs, us, cfg)
        b = tbw.backward_pass(tp, xs, us, cfg, reg=0.5)
        for x, y in zip(a, b):
            assert x.dtype == torch.float32
            assert torch.equal(x, y)
        ref = tbw.backward_pass(tp, xs.double(), us.double(), cfg)
        for x, y in zip(a, ref):
            assert_close(x.double(), y, 1e-4, 1e-5)


@pytest.mark.parametrize("n,m", [(4, 2), (3, 1), (16, 8)])
def test_plain_batched_equals_batch_last_on_transposed_inputs(n, m):
    B, T = 5, 4
    steps, final = _models(n, m, B, T, seed=n)
    arrays = tuple(to_torch(a) for a in
                   (steps[0], steps[1], steps[3], steps[4], steps[5],
                    steps[6], steps[7], final[1], final[2]))
    reg = to_torch(np.logspace(-3, 0, B))
    bf = riccati_scan_plain_batched(*arrays, reg)
    bl = riccati_scan_plain_bl(*to_batch_last(arrays), reg)
    assert bf[0].shape == (B, T, m) and bf[1].shape == (B, T, m, n)
    assert bf[2].shape == bf[3].shape == (B,)
    for f, l, moved in zip(bf, bl, (True, True, False, False)):
        assert torch.equal(f, l.movedim(-1, 0) if moved else l)
    # The wrapper on CPU tensors is the plain version, and launches nothing.
    before = cuda_riccati.launches()
    for f, w in zip(bf, riccati_scan_cuda_batched(*arrays, reg)):
        assert torch.equal(f, w)
    assert cuda_riccati.launches() == before
    # A scalar reg is the same as a lane vector of it.
    for f, s in zip(riccati_scan_cuda_batched(*arrays, reg=0.1),
                    riccati_scan_cuda_batched(*arrays, reg=torch.full(
                        (B,), 0.1, dtype=torch.float64))):
        assert torch.equal(f, s)


def test_batched_entry_against_the_pallas_kernel_in_interpret_mode():
    """The JAX batch-first entry itself (Pallas, interpret mode: seconds at
    B=3, T=8) against the port's, on its CPU path."""

    B, T, n, m = 3, 8, 4, 2
    steps, final = _models(n, m, B, T, seed=7)
    arrays = (steps[0], steps[1], steps[3], steps[4], steps[5], steps[6],
              steps[7], final[1], final[2])
    reg = np.array([1e-2, 0.1, 1.0])
    ref = riccati_scan_pallas_batched(*map(jnp.asarray, arrays),
                                      reg=jnp.asarray(reg), symmetrize=True,
                                      interpret=True)
    out = riccati_scan_cuda_batched(*map(to_torch, arrays), to_torch(reg))
    for name, o, r in zip(("duffs", "Ks", "dv1", "dv2"), out, ref):
        assert_close(o, r, RTOL, ATOL if name in ("duffs", "Ks") else 0.0,
                     err_msg=name)


def test_dispatch_flattens_leading_axes():
    """Several leading axes are one batch axis to the kernel's entry."""

    n, m, T = 4, 2, 5
    steps, final = _models(n, m, 6, T, seed=8)
    arrays = tuple(to_torch(a) for a in
                   (steps[0], steps[1], steps[3], steps[4], steps[5],
                    steps[6], steps[7], final[1], final[2]))
    reg = to_torch(np.logspace(-2, 0, 6))
    op = riccati_dispatch.make_riccati_op(True)
    flat = op(*arrays, reg)
    grid = op(*(a.reshape((2, 3) + a.shape[1:]) for a in arrays),
              reg.reshape(2, 3))
    for f, g in zip(flat, grid):
        assert g.shape == (2, 3) + f.shape[1:]
        assert torch.equal(f, g.reshape(f.shape))


def test_associative_backend_raises():
    """The parallel-in-time backend, refused until it was ported, now runs
    and agrees with the JAX package's (``tests/test_torch_pit.py`` holds it
    further); an unknown backend still raises and names itself."""

    cfg = ILQRConfig(backward_backend="associative", reg=0.0)
    xs = torch.zeros((5, 4), dtype=torch.float64)
    us = torch.zeros((4, 2), dtype=torch.float64)
    got = tbw.backward_pass(make_two_link_problem(), xs, us, cfg)
    want = jbw.backward_pass(jax_two_link(), jnp.zeros((5, 4)),
                             jnp.zeros((4, 2)),
                             JaxConfig(backward_backend="associative",
                                       reg=0.0))
    for name, g, w in zip(want._fields, got, want):
        assert_close(g, w, 1e-9, 1e-12, err_msg=name)
    with pytest.raises(NotImplementedError, match="no_such"):
        tbw.backward_pass(make_two_link_problem(), xs, us,
                          dataclasses.replace(cfg, backward_backend="no_such"))

