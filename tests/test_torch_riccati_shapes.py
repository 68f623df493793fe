"""The Riccati kernel at any ``(n, m)``: its plain version at shapes that no
fixed instantiation has, the padding rule of ``csrc/riccati_wide.cu``, and
the routing of a shape to a source (``riccati.cu``, ``riccati_wide.cu`` or,
past the padded ``(24, 12)``, ``riccati_large.cu``), float64, CPU.

* ``(7, 3)``: the port's plain version (and the wrapper on CPU tensors)
  against the JAX ``riccati_scan_pallas_bl`` in interpret mode — the TPU
  kernel, specialized for whatever shape reaches it — at T=8, B=4, rtol
  1e-10 (the matrices also atol 1e-12, as ``tests/test_torch_riccati.py``).
* ``(17, 8)`` (the RBD arm under ``al_solve``), and ``(25, 12)`` (the 6-DoF
  arm under ``al_solve``) and ``(29, 5)`` past the wide plan: against the
  JAX ``backward.riccati_scan`` un-jitted on single lanes, rtol 1e-10 /
  atol 1e-12, the bar ``tests/test_pallas_riccati.py`` holds the Pallas
  kernel to against that scan (``ROADMAP.md`` C9: the Pallas interpreter
  takes minutes at n >= 16 on a CPU).
* The padding rule: the plain version on inputs zero-padded to the wide
  kernel's tiles, the padded diagonal of H set to 1, equals the unpadded
  recursion on the logical block bit for bit, with its products summed in
  index order as the kernel sums them (``torch.sum``'s reduction tree
  depends on the length of the axis, so its sums over a padded axis round
  otherwise: there the two agree to rtol 1e-13).
* The routing as pure Python: the fixed instantiations keep their names,
  ``(17, 8)`` goes to the wide source padded to ``(24, 8)``, ``(6, 11)``
  to ``(8, 12)``; ``(25, 12)``, ``(32, 16)``, ``(29, 5)``, ``(32, 12)``
  and ``(10, 13)``, which pad past ``(24, 12)``, go to
  ``riccati_large.cu`` unpadded; ``(33, 12)``, ``(25, 17)``, ``(24, 24)``,
  ``(33, 1)`` and ``(40, 20)``, past ``(32, 16)``, to ``riccati_xl.cu``
  unpadded; ``(65, 1)``, ``(1, 33)`` and ``(80, 40)``, past ``(64, 32)``,
  to ``riccati_cluster.cu``; shapes past ``(128, 64)`` raise naming that
  ceiling before any ``nvcc`` run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.backward import riccati_scan as jax_riccati_scan
from ilqr_tpu.ops.pallas_riccati import riccati_scan_pallas_bl
from ilqr_tpu_torch.ops import cuda_riccati
from ilqr_tpu_torch.ops.cuda_riccati import (riccati_scan_cuda_bl,
                                             riccati_scan_plain_bl)
from tests.torch_parity import assert_close, to_torch

torch.set_num_threads(1)

NAMES = ("duffs", "Ks", "dv1", "dv2")


def synthetic_models(n, m, B, T, seed):
    """Batch-last local models ``(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN)``
    of a stable, well-conditioned problem, numpy float64."""

    rng = np.random.default_rng(seed)

    def spd(k, scale):
        X = rng.standard_normal((T, k, k, B)) / np.sqrt(k)
        return (np.einsum("tikb,tjkb->tijb", X, X) * scale
                + np.eye(k)[None, :, :, None])

    As = (0.9 * np.eye(n)[None, :, :, None]
          + 0.1 * rng.standard_normal((T, n, n, B)) / np.sqrt(n))
    Bs = 0.3 * rng.standard_normal((T, n, m, B))
    qx = 0.1 * rng.standard_normal((T, n, B))
    ru = 0.1 * rng.standard_normal((T, m, B))
    Qxx = 0.1 * spd(n, 0.5)
    Pux = 0.05 * rng.standard_normal((T, m, n, B))
    Ruu = spd(m, 0.2)
    qxN = rng.standard_normal((n, B))
    QN = spd(n, 1.0)[0]
    return As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN


def check(port, ref, rtol=1e-10):
    for name, p, r in zip(NAMES, port, ref):
        assert_close(p, r, rtol, 1e-12 if p.ndim > 1 else 0.0, err_msg=name)


def test_plain_at_7x3_matches_the_pallas_kernel():
    models = synthetic_models(7, 3, B=4, T=8, seed=0)
    reg = np.array([1e-3, 1e-2, 0.1, 1.0])
    ref = riccati_scan_pallas_bl(*(jnp.asarray(a) for a in models),
                                 reg=jnp.asarray(reg), interpret=True)
    tm = tuple(to_torch(a) for a in models)
    check(riccati_scan_plain_bl(*tm, to_torch(reg)), ref)
    # The wrapper on CPU tensors is the plain version at any shape.
    check(riccati_scan_cuda_bl(*tm, to_torch(reg)), ref)


def check_against_jax_scan(n, m, B, T, seed):
    """The plain version against the JAX ``riccati_scan``, un-jitted, one
    lane at a time."""

    models = synthetic_models(n, m, B, T, seed=seed)
    reg = 1e-2
    port = riccati_scan_plain_bl(*(to_torch(a) for a in models), reg)
    for b in range(B):
        As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN = (jnp.asarray(a[..., b])
                                                  for a in models)
        zeros = jnp.zeros((T,))
        ref = jax_riccati_scan(As, Bs, zeros, qx, ru, Qxx, Pux, Ruu, 0.0,
                               qxN, QN, reg=reg, symmetrize=True)
        check(tuple(p[..., b] for p in port),
              (ref.duffs, ref.Ks, ref.dV1, ref.dV2))


def test_plain_at_17x8_matches_the_jax_scan():
    check_against_jax_scan(17, 8, B=2, T=8, seed=1)


@pytest.mark.parametrize("n,m", [(25, 12), (29, 5)])
def test_plain_past_the_wide_plan_matches_the_jax_scan(n, m):
    # The shapes riccati_large.cu runs: the plain version takes them as it
    # takes any other, and is its oracle on the card.
    assert cuda_riccati.route(n, m) == ("riccati_large", n, m)
    check_against_jax_scan(n, m, B=2, T=4, seed=n + m)


def pad(models, n, m, N, M):
    """The wide kernel's padded inputs: zeros past the logical block, and
    the padded diagonal of Ruu — so of H = Ruu + B'SB, whose padded rows and
    columns are otherwise zero — set to 1."""

    As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN = models
    T, B = As.shape[0], As.shape[-1]

    def grow(x, shape):
        out = torch.zeros(shape, dtype=x.dtype)
        out[tuple(slice(0, k) for k in x.shape)] = x
        return out

    Ruu_p = grow(Ruu, (T, M, M, B))
    for i in range(m, M):
        Ruu_p[:, i, i, :] = 1.0
    return (grow(As, (T, N, N, B)), grow(Bs, (T, N, M, B)),
            grow(qx, (T, N, B)), grow(ru, (T, M, B)), grow(Qxx, (T, N, N, B)),
            grow(Pux, (T, M, N, B)), Ruu_p, grow(qxN, (N, B)),
            grow(QN, (N, N, B)))


def ordered_sum(x, dim):
    """``x.sum(dim)`` added in index order, as the kernel's loops add."""

    acc = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc


ORDERED = {
    "mm_bl": lambda A, B: ordered_sum(A[:, :, None, :] * B[None], 1),
    "mtm_bl": lambda A, B: ordered_sum(A[:, :, None, :] * B[:, None], 0),
    "mv_bl": lambda A, x: ordered_sum(A * x[None], 1),
    "mtv_bl": lambda A, x: ordered_sum(A * x[:, None], 0),
    "vv_bl": lambda x, y: ordered_sum(x * y, 0),
}


@pytest.mark.parametrize("n,m", [(7, 3), (17, 8), (6, 1), (6, 11)])
def test_padding_is_exact(n, m, monkeypatch):
    source, N, M = cuda_riccati.route(n, m)
    assert source == "riccati_wide" and (N, M) != (n, m)
    models = tuple(to_torch(a) for a in synthetic_models(n, m, 3, 6, seed=n))
    padded = pad(models, n, m, N, M)
    reg = torch.tensor([0.0, 1e-2, 1.0], dtype=torch.float64)
    for sym in (True, False):
        stock = riccati_scan_plain_bl(*padded, reg, symmetrize=sym)
        want = riccati_scan_plain_bl(*models, reg, symmetrize=sym)
        check((stock[0][:, :m], stock[1][:, :m, :n]) + stock[2:], want,
              rtol=1e-13)
    for name, fn in ORDERED.items():
        monkeypatch.setattr(cuda_riccati.sm, name, fn)
    for sym in (True, False):
        want = riccati_scan_plain_bl(*models, reg, symmetrize=sym)
        got = riccati_scan_plain_bl(*padded, reg, symmetrize=sym)
        duffs, Ks, dv1, dv2 = got
        assert torch.equal(duffs[:, :m], want[0])
        assert torch.equal(Ks[:, :m, :n], want[1])
        assert torch.equal(dv1, want[2]) and torch.equal(dv2, want[3])
        # The padded gains are exact zeros.
        assert not duffs[:, m:].any() and not Ks[:, m:].any()
        assert not Ks[:, :, n:].any()


def test_routing():
    f32, f64 = torch.float32, torch.float64
    # The fixed instantiations keep their names and sources.
    for (n, m, dtype), name in cuda_riccati.KERNELS.items():
        assert cuda_riccati.kernel_name(n, m, dtype) == name
        assert cuda_riccati.library_and_symbol(n, m, dtype) == (
            "riccati" if n <= 5 else "riccati_wide", name)
    assert cuda_riccati.kernel_name(4, 2, f32) == "riccati_cuda_4x2_f32"
    assert cuda_riccati.kernel_name(24, 12, f64) == "riccati_cuda_24x12_f64"
    # Another shape: an instantiation built at first use.
    assert cuda_riccati.route(17, 8) == ("riccati_wide", 24, 8)
    assert cuda_riccati.route(7, 3) == ("riccati_wide", 8, 4)
    assert cuda_riccati.route(3, 1) == ("riccati", 3, 1)
    assert cuda_riccati.route(5, 5) == ("riccati", 5, 5)
    # More controls than states: the wide source, M past N.
    assert cuda_riccati.route(6, 11) == ("riccati_wide", 8, 12)
    assert cuda_riccati.kernel_name(17, 8, f32) == "riccati_cuda_17x8_f32"
    assert cuda_riccati.library_and_symbol(17, 8, f32) == (
        "riccati_wide_17x8_f32", "riccati_cuda_instance")
    assert cuda_riccati.library_and_symbol(3, 1, f64) == (
        "riccati_3x1_f64", "riccati_cuda_instance")
    # The padded (24, 12) is the wide plan's last shape; past it the large
    # plan takes the logical shape, unpadded, up to (32, 16).
    assert cuda_riccati.route(24, 12) == ("riccati_wide", 24, 12)
    for n, m in ((25, 12), (32, 16), (29, 5), (32, 12), (10, 13), (25, 1),
                 (1, 16)):
        assert cuda_riccati.route(n, m) == ("riccati_large", n, m)
    assert cuda_riccati.kernel_name(25, 12, f32) == "riccati_cuda_25x12_f32"
    assert cuda_riccati.library_and_symbol(25, 12, f32) == (
        "riccati_large_25x12_f32", "riccati_cuda_instance")
    assert cuda_riccati.library_and_symbol(32, 16, f64) == (
        "riccati_large_32x16_f64", "riccati_cuda_instance")
    assert cuda_riccati.LARGE_MAX == (32, 16)
    # Past (32, 16), up to (64, 32): riccati_xl.cu at the logical shape, an
    # instantiation built at first use in either type.
    for n, m in ((33, 12), (25, 17), (24, 24), (33, 1), (40, 20)):
        assert cuda_riccati.route(n, m) == ("riccati_xl", n, m)
        for dtype, tag in ((f32, "f32"), (f64, "f64")):
            assert cuda_riccati.kernel_name(n, m, dtype) == (
                f"riccati_cuda_{n}x{m}_{tag}")
            assert cuda_riccati.library_and_symbol(n, m, dtype) == (
                f"riccati_xl_{n}x{m}_{tag}", "riccati_cuda_instance")
    assert cuda_riccati.XL_MAX == (64, 32)
    # Past (64, 32), up to (128, 64): riccati_cluster.cu, a cluster of
    # blocks a lane, at the logical shape.
    for n, m in ((65, 1), (1, 33), (80, 40)):
        assert cuda_riccati.route(n, m) == ("riccati_cluster", n, m)
        for dtype, tag in ((f32, "f32"), (f64, "f64")):
            assert cuda_riccati.kernel_name(n, m, dtype) == (
                f"riccati_cuda_{n}x{m}_{tag}")
            assert cuda_riccati.library_and_symbol(n, m, dtype) == (
                f"riccati_cluster_{n}x{m}_{tag}", "riccati_cuda_instance")
    assert cuda_riccati.CLUSTER_MAX == (128, 64)
    # Past (128, 64), the largest shape held on the card: refused before any
    # nvcc run, in either type, with the ceiling named.
    for n, m in ((129, 1), (1, 65), (160, 80)):
        for dtype in (f32, f64):
            with pytest.raises(NotImplementedError,
                               match=r"n <= 128 and m <= 64.*\(128, 64\)"):
                cuda_riccati.kernel_name(n, m, dtype)
    with pytest.raises(NotImplementedError, match="float16"):
        cuda_riccati.kernel_name(4, 2, torch.float16)


def test_build_flags_of_an_instantiation():
    from ilqr_tpu_torch.ops import _build

    src, flags = _build._source_and_flags("riccati_wide_17x8_f32")
    assert src.name == "riccati_wide.cu"
    assert flags[-3:] == ("-DRICCATI_N=17", "-DRICCATI_M=8",
                          "-DRICCATI_SCALAR=float")
    src, flags = _build._source_and_flags("riccati_3x1_f64_clocks")
    assert src.name == "riccati.cu"
    assert flags[-2:] == ("-DRICCATI_SCALAR=double", "-DRICCATI_STAGE_CLOCKS")
    # riccati_large.cu is built only as an instantiation: it has no fixed
    # library of its own.
    src, flags = _build._source_and_flags("riccati_large_25x12_f32")
    assert src.name == "riccati_large.cu"
    assert flags[-3:] == ("-DRICCATI_N=25", "-DRICCATI_M=12",
                          "-DRICCATI_SCALAR=float")
    assert "riccati_large" not in _build.SOURCES
    assert "riccati_large" in _build.INSTANCE_SOURCES
    # The fixed libraries keep their flags.
    assert _build._source_and_flags("riccati_wide")[1] == _build.NVCC_FLAGS
    assert _build._source_and_flags("riccati_clocks")[1] == (
        _build.NVCC_FLAGS + ("-DRICCATI_STAGE_CLOCKS",))
    assert (_build.library_path("riccati_wide_17x8_f32")
            != _build.library_path("riccati_wide_17x8_f64"))
    with pytest.raises(ValueError):
        _build._source_and_flags("no_such_source")


@pytest.mark.gpu
def test_new_shapes_on_the_card():
    """Needs the card: the instantiations built at first use against the
    plain version, float64, both entries."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for n, m in ((17, 8), (7, 3), (3, 1), (5, 5), (6, 11), (25, 12),
                 (32, 16), (29, 5)):
        models = tuple(to_torch(a).cuda()
                       for a in synthetic_models(n, m, 5, 7, seed=n))
        name = cuda_riccati.kernel_name(n, m, torch.float64)
        before = cuda_riccati.launch_counts.get(name, 0)
        out = riccati_scan_cuda_bl(*models, 1e-2)
        assert cuda_riccati.launch_counts[name] == before + 1
        check(out, riccati_scan_plain_bl(*models, 1e-2))
        bf = cuda_riccati.riccati_scan_cuda_batched(
            *(x.movedim(-1, 0).contiguous() for x in models), 1e-2)
        for a, b in zip(cuda_riccati.from_batch_last(out), bf):
            assert torch.equal(a, b)
