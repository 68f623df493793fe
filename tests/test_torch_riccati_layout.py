"""The Riccati kernels' two layouts, on the CPU.

* The batch-first entry ``riccati_scan_cuda_batched`` on CPU tensors (its
  plain version) against ``riccati_scan_plain_batched``, the JAX scan and
  the JAX ``riccati_scan_pallas_batched`` in interpret mode (as
  ``tests/test_pallas_riccati.py`` runs it on the CPU), float64, rtol 1e-10 /
  atol 1e-12 (``dv1``/``dv2`` rtol 1e-9, the bar of that test).
* The wide kernel's order of operations (``S`` from ``P + K'W + G'K``, ``s``
  from ``ys + K'(H duff + g) + G'duff``), transcribed in PyTorch, against
  the JAX scan at the same bar.
* The pure-Python pieces of the wrapper: the shapes the layout argument
  reads (each input checked), :func:`as_kernel_input`, and both entries on
  CPU tensors agreeing bit for bit at every instantiation, ragged batches
  included.

The kernels themselves, their launch geometry and the copy path each
launch takes (TMA or per element, chosen by the launcher from the
pointers, the batch and the layout) are checked on the card only
(``chip_smoke.py``); one test here is marked ``gpu`` and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.batched import riccati_bl_scan as jax_riccati_bl_scan
from ilqr_tpu.ops.pallas_riccati import riccati_scan_pallas_batched
from ilqr_tpu_torch.ops import cuda_riccati
from ilqr_tpu_torch.ops import smallmat as sm
from ilqr_tpu_torch.ops.cuda_riccati import (BATCH_FIRST, BATCH_LAST,
                                             as_kernel_input, from_batch_last,
                                             riccati_scan_cuda_batched,
                                             riccati_scan_cuda_bl,
                                             riccati_scan_plain_batched)
from tests.torch_parity import assert_close, to_torch

RTOL = (1e-10, 1e-10, 1e-9, 1e-9)
ATOL = (1e-12, 1e-12, 0.0, 0.0)
NAMES = ("duffs", "Ks", "dv1", "dv2")
INSTANTIATIONS = sorted(cuda_riccati.KERNELS, key=str)


def _models_bl(n, m, B, T, seed):
    """Batch-last local models with SPD cost blocks and near-identity
    dynamics, as numpy arrays."""

    rng = np.random.default_rng(seed)

    def spd(k):
        R = rng.standard_normal((T, k, k, B))
        return (np.einsum("tikb,tjkb->tijb", R, R) / k
                + np.eye(k)[None, :, :, None])

    return (np.eye(n)[None, :, :, None]
            + 0.1 * rng.standard_normal((T, n, n, B)),
            0.3 * rng.standard_normal((T, n, m, B)),
            rng.standard_normal((T, n, B)), rng.standard_normal((T, m, B)),
            spd(n), 0.1 * rng.standard_normal((T, m, n, B)), spd(m),
            rng.standard_normal((n, B)), spd(n)[0])


def _batch_first(models):
    return tuple(np.ascontiguousarray(np.moveaxis(a, -1, 0)) for a in models)


def _check(out, ref):
    for name, o, r, rtol, atol in zip(NAMES, out, ref, RTOL, ATOL):
        assert_close(o, r, rtol, atol, err_msg=name)


_cache = {}


def _case(T):
    """Batch-last models of 33 lanes at horizon T, their per-lane reg and
    the JAX scan's outputs, once per T; a batch of B lanes is the first B
    (lanes are independent)."""

    if T not in _cache:
        models = _models_bl(4, 2, 33, T, seed=T)
        reg = np.logspace(-3, 0, 33)
        ref = jax_riccati_bl_scan(*(jnp.asarray(a) for a in models),
                                  jnp.asarray(reg), symmetrize=True)
        _cache[T] = (models, reg, tuple(np.asarray(r) for r in ref))
    return _cache[T]


def _first(arrays, B):
    return tuple(a[..., :B] for a in arrays)


BT = [(B, T) for B in (1, 3, 33) for T in (1, 7, 24)]


@pytest.mark.parametrize("B,T", BT, ids=[f"B{B}-T{T}" for B, T in BT])
def test_batched_entry_on_cpu_matches_plain_and_jax_scan(B, T):
    models, reg, ref = _case(T)
    bf = tuple(to_torch(a) for a in _batch_first(_first(models, B)))
    before = cuda_riccati.launches()
    out = riccati_scan_cuda_batched(*bf, to_torch(reg[:B]), symmetrize=True)
    assert cuda_riccati.launches() == before    # CPU tensors: plain version
    assert out[0].shape == (B, T, 2) and out[1].shape == (B, T, 2, 4)
    plain = riccati_scan_plain_batched(*bf, to_torch(reg[:B]),
                                       symmetrize=True)
    for o, p in zip(out, plain):
        assert torch.equal(o, p)
    duffs, Ks, dv1, dv2 = _first(ref, B)
    _check(out, (np.moveaxis(duffs, -1, 0), np.moveaxis(Ks, -1, 0), dv1,
                 dv2))


# Each B and each T of the grid above once: an interpret-mode run of the
# TPU kernel takes seconds on the CPU whatever the shape.
PALLAS_BT = [(1, 1), (3, 7), (33, 24)]


@pytest.mark.parametrize("B,T", PALLAS_BT,
                         ids=[f"B{B}-T{T}" for B, T in PALLAS_BT])
def test_batched_entry_on_cpu_matches_pallas_interpret(B, T):
    models, reg, _ = _case(T)
    bf = _batch_first(_first(models, B))
    out = riccati_scan_cuda_batched(*(to_torch(a) for a in bf),
                                    to_torch(reg[:B]), symmetrize=True)
    ref = riccati_scan_pallas_batched(*(jnp.asarray(a) for a in bf),
                                      reg=jnp.asarray(reg[:B]),
                                      symmetrize=True, interpret=True)
    _check(out, ref)


def wide_order_bl(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                  symmetrize=True):
    """The recursion in the order of ``csrc/riccati_wide.cu``: the gains
    by the reference's substitutions (one ``rsqrt`` a pivot), then ``W = G +
    H K``; ``Sn = (Qxx + A'(SA)) + K'W + G'K``; ``s = (qx + A's) + K'(H duff
    + g) + G'duff`` (the reference sums ``Qxx + A'SA + K'HK + K'G + G'K``)."""

    T = As.shape[0]
    S, s = QN, qxN
    duffs, Ks = [None] * T, [None] * T
    dv1 = torch.zeros_like(qxN[0])
    dv2 = torch.zeros_like(qxN[0])
    for t in reversed(range(T)):
        A, B = As[t], Bs[t]
        BtS = sm.mtm_bl(B, S)
        g = ru[t] + sm.mtv_bl(B, s)
        ys = qx[t] + sm.mtv_bl(A, s)
        G = Pux[t] + sm.mm_bl(BtS, A)
        H = Ruu[t] + sm.mm_bl(BtS, B)
        P = Qxx[t] + sm.mtm_bl(A, sm.mm_bl(S, A))
        L, invd = sm.cholesky_rsqrt_bl(H, reg)
        duff = -sm.cho_solve_bl(L, g, invd)
        K = -sm.cho_solve_bl(L, G, invd)
        W = G + sm.mm_bl(H, K)
        Hd = sm.mv_bl(H, duff)
        Sn = P + sm.mtm_bl(K, W) + sm.mtm_bl(G, K)
        S = 0.5 * (Sn + sm.transpose_bl(Sn)) if symmetrize else Sn
        s = ys + sm.mtv_bl(K, Hd + g) + sm.mtv_bl(G, duff)
        duffs[t], Ks[t] = duff, K
        dv1 = dv1 + sm.vv_bl(duff, g)
        dv2 = dv2 + 0.5 * sm.vv_bl(duff, Hd)
    return torch.stack(duffs, dim=0), torch.stack(Ks, dim=0), dv1, dv2


# Both values of symmetrize at (4, 2), one each at the wide shapes (a JAX
# compile at (24, 12) takes seconds).
ORDER_CASES = [(4, 2, True), (4, 2, False), (16, 8, True), (24, 12, False)]


@pytest.mark.parametrize("n,m,symmetrize", ORDER_CASES)
def test_wide_kernel_order_matches_jax_scan(n, m, symmetrize):
    B, T = 3, 6
    models = _models_bl(n, m, B, T, seed=n + m)
    reg = np.array([1e-3, 1e-1, 1.0])
    ref = jax_riccati_bl_scan(*(jnp.asarray(a) for a in models),
                              jnp.asarray(reg), symmetrize=symmetrize)
    out = wide_order_bl(*(to_torch(a) for a in models), to_torch(reg),
                        symmetrize=symmetrize)
    _check(out, ref)


def _shapes_bf(n, m, B, T):
    return [(B, T, n, n), (B, T, n, m), (B, T, n), (B, T, m), (B, T, n, n),
            (B, T, m, n), (B, T, m, m), (B, n), (B, n, n)]


@pytest.mark.parametrize("layout", [BATCH_LAST, BATCH_FIRST],
                         ids=["batch_last", "batch_first"])
@pytest.mark.parametrize("n,m", [(4, 2), (5, 2), (16, 8), (24, 12)])
def test_layout_argument_reads_the_shapes(n, m, layout):
    B, T = 4099, 7
    bf = [torch.empty(s) for s in _shapes_bf(n, m, B, T)]
    arrays = bf if layout == BATCH_FIRST else [x.movedim(0, -1) for x in bf]
    assert cuda_riccati._shapes(*arrays, layout) == (T, n, m, B)
    wrong = BATCH_LAST if layout == BATCH_FIRST else BATCH_FIRST
    with pytest.raises(ValueError):
        cuda_riccati._shapes(*arrays, wrong)


NAMES_IN = ("As", "Bs", "qx", "ru", "Qxx", "Pux", "Ruu", "qxN", "QN")


@pytest.mark.parametrize("k", range(9), ids=NAMES_IN)
@pytest.mark.parametrize("layout", [BATCH_LAST, BATCH_FIRST],
                         ids=["batch_last", "batch_first"])
def test_layout_argument_checks_each_input(layout, k):
    """One input one row too long (``Bs`` one state too many, since ``m``
    is read from it) is refused by name."""

    n, m, B, T = 16, 8, 67, 7
    shapes = _shapes_bf(n, m, B, T)
    if layout == BATCH_LAST:
        shapes = [s[1:] + s[:1] for s in shapes]
    axis = (-3 if layout == BATCH_LAST else -2) if k == 1 else (
        -2 if layout == BATCH_LAST else -1)
    wrong = list(shapes[k])
    wrong[axis] += 1
    shapes[k] = tuple(wrong)
    with pytest.raises(ValueError, match=f"^{NAMES_IN[k]} must be"):
        cuda_riccati._shapes(*(torch.empty(s) for s in shapes), layout)


# Each instantiation at one lane and at a ragged batch: the batch-first
# widths chip_smoke.py launches on the card for the wide kernel, the
# ragged width of its batch-last checks for (4, 2), one warp and a lane for
# (5, 2).
RAGGED = {(4, 2): 4099, (5, 2): 33, (16, 8): 65, (24, 12): 67}
ENTRY_CASES = [(n, m, dtype, B) for n, m, dtype in INSTANTIATIONS
               for B in (1, RAGGED[(n, m)])]


@pytest.mark.parametrize(
    "n,m,dtype,B", ENTRY_CASES,
    ids=[f"{n}x{m}-{str(d)[6:]}-B{B}" for n, m, d, B in ENTRY_CASES])
def test_cpu_entries_agree_across_layouts(n, m, dtype, B):
    bl = tuple(to_torch(a).to(dtype) for a in _models_bl(n, m, B, 3, B + n))
    reg = torch.logspace(-3, 0, B, dtype=dtype)
    before = cuda_riccati.launches()
    want = from_batch_last(riccati_scan_cuda_bl(*bl, reg))
    got = riccati_scan_cuda_batched(
        *(x.movedim(-1, 0).contiguous() for x in bl), reg)
    assert cuda_riccati.launches() == before    # CPU tensors: plain version
    assert got[0].shape == (B, 3, m) and got[1].shape == (B, 3, m, n)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == dtype, name
        assert torch.equal(g, w), name
        assert bool(torch.isfinite(g).all()), name


def test_kernel_inputs_are_copied_only_when_needed():
    x = torch.zeros((5, 7, 4))
    assert as_kernel_input(x) is x
    view = x.transpose(0, 1)
    y = as_kernel_input(view)
    assert y.is_contiguous() and torch.equal(y, view)
    flat = torch.arange(9.0, dtype=torch.float32)
    shifted = flat[1:]                     # contiguous, 4 bytes off
    assert shifted.data_ptr() % 16 == 4
    z = as_kernel_input(shifted)
    assert z.data_ptr() % 16 == 0 and torch.equal(z, shifted)


@pytest.mark.gpu
def test_batch_first_equals_batch_last_on_the_card():
    """Needs the card: both layouts of each kernel, bit for bit."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for n, m in ((4, 2), (5, 2), (16, 8), (24, 12)):
        models = tuple(to_torch(a).cuda() for a in _models_bl(n, m, 9, 5, 1))
        bl = cuda_riccati.riccati_scan_cuda_bl(*models, 1e-2)
        bf = riccati_scan_cuda_batched(
            *(x.movedim(-1, 0).contiguous() for x in models), 1e-2)
        for a, b in zip(cuda_riccati.from_batch_last(bl), bf):
            assert torch.equal(a, b)
