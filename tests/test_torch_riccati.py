"""The port's backward Riccati recursion against the JAX package's.

The same local models (numpy, from the JAX ``derivatives_bl`` at a rolled
out iterate) go through

* JAX ``riccati_bl_scan`` (the lax.scan backend) and
* JAX ``riccati_scan_pallas_bl(..., interpret=True)`` — the TPU kernel run
  on the CPU the way the JAX package's own tests run it —

and through the port's ``riccati_scan_plain_bl`` (the CUDA kernel's plain
version, rsqrt reciprocals), ``riccati_bl_scan`` (sqrt then divide) and the
wrapper ``riccati_scan_cuda_bl`` on CPU tensors.  float64; ``duffs``/``Ks``
to rtol 1e-10 / atol 1e-12 and ``dv1``/``dv2`` to rtol 1e-9, the bar of
``tests/test_pallas_riccati.py`` (the recursions differ in the order of
their sums and in rsqrt against sqrt-then-divide).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.batched import riccati_bl_scan as jax_riccati_bl_scan
from ilqr_tpu.models.two_link import make_two_link_problem as jax_two_link
from ilqr_tpu.ops.pallas_riccati import riccati_scan_pallas_bl
from ilqr_tpu_torch.batched import riccati_bl_scan
from ilqr_tpu_torch.convert import local_models_from_numpy
from ilqr_tpu_torch.ops import cuda_riccati
from ilqr_tpu_torch.ops.cuda_riccati import (riccati_scan_cuda_bl,
                                             riccati_scan_plain_bl)
from tests.torch_parity import assert_close, jax_local_models, to_torch

T = 24
_cache = {}


def _case(B, per_lane_reg, symmetrize):
    """Inputs and the two JAX references, computed once per case."""

    key = (B, per_lane_reg, symmetrize)
    if key not in _cache:
        models = _cache.setdefault(
            ("models", B), jax_local_models(jax_two_link(), B, T, seed=B))
        rng = np.random.default_rng(100 + B)
        reg = 10.0 ** rng.uniform(-4, 0, B) if per_lane_reg else 1e-2
        jm = tuple(jnp.asarray(a) for a in models)
        jreg = jnp.asarray(reg) if per_lane_reg else reg
        scan = jax_riccati_bl_scan(*jm, jreg, symmetrize=symmetrize)
        pallas = riccati_scan_pallas_bl(*jm, reg=jreg, symmetrize=symmetrize,
                                        interpret=True)
        _cache[key] = (models, reg, scan, pallas)
    return _cache[key]


def _check(out, ref):
    for name, o, r, rtol, atol in zip(("duffs", "Ks", "dv1", "dv2"), out, ref,
                                      (1e-10, 1e-10, 1e-9, 1e-9),
                                      (1e-12, 1e-12, 0.0, 0.0)):
        assert_close(o, r, rtol, atol, err_msg=name)


# Both batch sizes (130 is more than the TPU kernel's lane width and less
# than its padded tile), each with both reg forms and both symmetrize values
# between its two cases.  Every case costs two JAX compilations.
CASES = [(3, False, True), (3, True, False),
         (130, False, True), (130, True, False)]
IDS = [f"B{B}-{'lane' if lane else 'scalar'}_reg-{'sym' if sym else 'nosym'}"
       for B, lane, sym in CASES]


@pytest.mark.parametrize("ref", ["jax_scan", "pallas_interpret"])
@pytest.mark.parametrize("fn", ["plain", "scan", "wrapper_on_cpu"])
@pytest.mark.parametrize("B,per_lane_reg,symmetrize", CASES, ids=IDS)
def test_recursion_matches_jax(B, per_lane_reg, symmetrize, fn, ref):
    models, reg, scan, pallas = _case(B, per_lane_reg, symmetrize)
    tm = local_models_from_numpy(models, device="cpu")
    treg = to_torch(reg) if per_lane_reg else reg
    run = {"plain": riccati_scan_plain_bl, "scan": riccati_bl_scan,
           "wrapper_on_cpu": riccati_scan_cuda_bl}[fn]
    before = cuda_riccati.launches()
    out = run(*tm, treg, symmetrize=symmetrize)
    assert cuda_riccati.launches() == before  # no kernel launch on the CPU
    assert out[0].shape == (T, 2, B) and out[1].shape == (T, 2, 4, B)
    assert out[2].shape == (B,) and out[3].shape == (B,)
    _check(out, scan if ref == "jax_scan" else pallas)


def test_symmetrize_changes_the_recursion():
    """The flag reaches the loop: with it off S drifts from symmetric and
    the gains differ (slightly) from the symmetrized run."""

    models, reg, _, _ = _case(3, False, True)
    tm = local_models_from_numpy(models, device="cpu")
    on = riccati_scan_plain_bl(*tm, reg, symmetrize=True)
    off = riccati_scan_plain_bl(*tm, reg, symmetrize=False)
    assert not torch.equal(on[1], off[1])


def _random_models(n, m, B, T, dtype=torch.float64):
    g = torch.Generator().manual_seed(0)
    shapes = [(T, n, n, B), (T, n, m, B), (T, n, B), (T, m, B), (T, n, n, B),
              (T, m, n, B), (T, m, m, B), (n, B), (n, n, B)]
    return tuple(torch.randn(s, generator=g, dtype=dtype) for s in shapes)


def test_wrapper_raises_on_missing_instantiation():
    """A shape or type with no kernel: the launcher table says so by name.
    A shape outside the fixed table is an instantiation built at first use
    up to n = 128, m = 64; a larger one has none.  On CPU tensors the
    wrapper needs no instantiation — it runs the plain version at any (n,
    m), as the JAX package runs its kernel in interpret mode there — and it
    launches nothing."""

    with pytest.raises(NotImplementedError, match=r"\(129, 64\)"):
        cuda_riccati.kernel_name(129, 64, torch.float64)
    assert cuda_riccati.kernel_name(65, 32, torch.float64) == (
        "riccati_cuda_65x32_f64")
    assert cuda_riccati.kernel_name(3, 1, torch.float64) == (
        "riccati_cuda_3x1_f64")
    assert cuda_riccati.kernel_name(25, 12, torch.float64) == (
        "riccati_cuda_25x12_f64")
    assert cuda_riccati.kernel_name(33, 16, torch.float64) == (
        "riccati_cuda_33x16_f64")
    with pytest.raises(NotImplementedError, match="float16"):
        cuda_riccati.kernel_name(4, 2, torch.float16)
    for n, m in ((4, 2), (5, 2), (16, 8), (24, 12)):
        for dtype in (torch.float32, torch.float64):
            name = cuda_riccati.kernel_name(n, m, dtype)
            assert name in cuda_riccati.launch_counts
            assert name in cuda_riccati.LIBRARY
    before = cuda_riccati.launches()
    models = _random_models(5, 3, 2, 3)
    out = riccati_scan_cuda_bl(*models, 1e-2)
    ref = riccati_scan_plain_bl(*models, 1e-2)
    # Bit for bit (random blocks are not positive definite: NaNs compare
    # equal where both have them).
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0.0, atol=0.0, equal_nan=True)
    assert cuda_riccati.launches() == before


def test_wrapper_checks_shapes_and_dtypes():
    models = list(_random_models(4, 2, 2, 3))
    bad = list(models)
    bad[2] = bad[2][:, :3]
    with pytest.raises(ValueError, match="qx"):
        riccati_scan_cuda_bl(*bad, 1e-2)
    bad = list(models)
    bad[8] = bad[8].float()
    with pytest.raises(ValueError, match="dtype"):
        riccati_scan_cuda_bl(*bad, 1e-2)


def test_plain_version_is_generic_in_n_and_m():
    """The plain version runs any (n, m); at (3, 1) with SPD blocks it
    matches the JAX scan."""

    rng = np.random.default_rng(5)
    n, m, B, Th = 3, 1, 4, 6

    def spd(k):
        R = rng.standard_normal((Th, k, k, B))
        return np.einsum("tikb,tjkb->tijb", R, R) + np.eye(k)[None, :, :, None]

    models = (0.5 * rng.standard_normal((Th, n, n, B)),
              rng.standard_normal((Th, n, m, B)),
              rng.standard_normal((Th, n, B)), rng.standard_normal((Th, m, B)),
              spd(n), np.zeros((Th, m, n, B)), spd(m),
              rng.standard_normal((n, B)), spd(n)[0])
    ref = jax_riccati_bl_scan(*(jnp.asarray(a) for a in models), 1e-2)
    out = riccati_scan_plain_bl(*local_models_from_numpy(models, device="cpu"),
                                1e-2)
    _check(out, ref)


def _spd_models(n, m, B, Th, seed):
    """Local models with SPD cost blocks and near-identity dynamics, as
    numpy arrays."""

    rng = np.random.default_rng(seed)

    def spd(k):
        R = rng.standard_normal((Th, k, k, B))
        return (np.einsum("tikb,tjkb->tijb", R, R) / k
                + np.eye(k)[None, :, :, None])

    return (np.eye(n)[None, :, :, None]
            + 0.1 * rng.standard_normal((Th, n, n, B)),
            0.3 * rng.standard_normal((Th, n, m, B)),
            rng.standard_normal((Th, n, B)), rng.standard_normal((Th, m, B)),
            spd(n), 0.1 * rng.standard_normal((Th, m, n, B)), spd(m),
            rng.standard_normal((n, B)), spd(n)[0])


@pytest.mark.parametrize("per_lane_reg", [False, True],
                         ids=["scalar_reg", "lane_reg"])
@pytest.mark.parametrize("n,m", [(16, 8), (24, 12)])
def test_plain_version_matches_jax_scan_at_the_rbd_shapes(n, m, per_lane_reg):
    """The plain version of the (16, 8) and (24, 12) kernels against the
    JAX scan, the TPU kernel's own reference in ``tests/
    test_pallas_riccati.py`` (at these shapes the kernel's interpret mode
    unrolls into a program that takes the CPU compiler many minutes): rtol
    1e-10, that test's bar."""

    B, Th = 3, 5
    models = _spd_models(n, m, B, Th, seed=n)
    reg = np.array([1e-3, 1e-1, 1.0]) if per_lane_reg else 1e-2
    jreg = jnp.asarray(reg) if per_lane_reg else reg
    ref = jax_riccati_bl_scan(*(jnp.asarray(a) for a in models), jreg,
                              symmetrize=not per_lane_reg)
    treg = to_torch(reg) if per_lane_reg else reg
    out = riccati_scan_plain_bl(*local_models_from_numpy(models, device="cpu"),
                                treg, symmetrize=not per_lane_reg)
    assert out[1].shape == (Th, m, n, B)
    _check(out, ref)


def test_pallas_backend_on_cpu_runs_any_shape():
    """``backward_backend="pallas"`` on CPU tensors at (3, 1), a shape with
    no kernel: the port runs the plain version, the JAX package its kernel
    in interpret mode, and they agree."""

    from ilqr_tpu.batched import riccati_bl as jax_riccati_bl
    from ilqr_tpu.config import ILQRConfig as JaxConfig
    from ilqr_tpu_torch.batched import riccati_bl
    from ilqr_tpu_torch.convert import config_from_fields

    jcfg = JaxConfig(backward_backend="pallas")
    models = _spd_models(3, 1, 4, 6, seed=9)
    ref = jax_riccati_bl(*(jnp.asarray(a) for a in models), reg=1e-2,
                         config=jcfg)
    before = cuda_riccati.launches()
    out = riccati_bl(*local_models_from_numpy(models, device="cpu"),
                     reg=1e-2, config=config_from_fields(jcfg))
    assert cuda_riccati.launches() == before
    _check(out, ref)


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    """Needs the card: the CUDA kernel against the plain version, float64."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    models, reg, _, _ = _case(130, False, True)
    tm = local_models_from_numpy(models, device="cuda")
    before = cuda_riccati.launches()
    out = riccati_scan_cuda_bl(*tm, reg)
    assert cuda_riccati.launches() == before + 1
    _check(out, riccati_scan_plain_bl(*tm, reg))
