"""The Riccati kernel past ``(32, 16)``, up to ``(64, 32)``: the shapes that
``csrc/riccati_xl.cu`` runs on the card, float64, CPU.

* The plain version, through both entries (``riccati_scan_cuda_bl`` and
  ``riccati_scan_cuda_batched`` on CPU tensors), at ``(33, 16)``, ``(36,
  18)`` (the free-flying dual arm) and ``(37, 18)`` (the dual arm under
  ``al_solve``), with ``symmetrize`` on and off, against the JAX
  ``backward.riccati_scan`` on the same numpy inputs: each output within
  1e-10 of its largest magnitude.  ``(20, 32)`` and ``(64, 32)``, the
  ceiling, are held the same way in ``tests/test_torch_riccati_xl_m32.py``.
  That scan is the recursion the Pallas kernel reproduces (held to it at
  1e-10 in ``tests/test_pallas_riccati.py``); the Pallas interpreter takes
  minutes at these shapes on a CPU (``ROADMAP.md`` C9), so it is not run
  here.  Nor is the scan compiled: XLA takes minutes over its
  scalar-unrolled Cholesky at m = 32 on a CPU.  What ``riccati_scan``'s
  ``lax.scan(reverse=True)`` runs, its ``backward.riccati_step`` from the
  terminal carry over t = T-1 ... 0 and the sums of its dv terms, runs
  here eagerly a lane at a time (a second or two a shape once JAX has
  cached its small programs; the scan under ``jax.disable_jit`` is several
  times slower, and slower still vmapped).
* The host side of the new source: its build flags, its ceiling, the copy
  path its launcher reports, its instantiation names.
* The kernel itself on the card (marked ``gpu``; skips here).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.backward import riccati_step
from ilqr_tpu_torch.ops import _build, cuda_riccati
from ilqr_tpu_torch.ops.cuda_riccati import (from_batch_last,
                                             riccati_scan_cuda_batched,
                                             riccati_scan_cuda_bl,
                                             riccati_scan_plain_bl)
from tests.test_torch_riccati_shapes import synthetic_models
from tests.torch_parity import to_numpy, to_torch

torch.set_num_threads(1)

NAMES = ("duffs", "Ks", "dv1", "dv2")
SHAPES = [(33, 16), (36, 18), (37, 18)]
# Every shape riccati_xl.cu serves in this file and in _m32.py, for the
# card's test.
CARD_SHAPES = SHAPES + [(20, 32), (64, 32)]
B, T = 2, 2
RTOL = 1e-10


def jax_scan_lane(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg, symmetrize):
    """One lane of ``riccati_scan``: its step over t = T-1 ... 0 from the
    terminal carry, the dv terms summed over t, run eagerly."""

    carry = (jnp.zeros(()), jnp.asarray(qxN), jnp.asarray(QN))
    outs = [None] * As.shape[0]
    for t in reversed(range(As.shape[0])):
        inp = tuple(jnp.asarray(x[t]) for x in (As, Bs))
        inp += (jnp.zeros(()),) + tuple(jnp.asarray(x[t]) for x in (
            qx, ru, Qxx, Pux, Ruu))
        carry, outs[t] = riccati_step(carry, inp, reg=reg,
                                      symmetrize=symmetrize)
    duffs, Ks, dv1, dv2 = (jnp.stack(o) for o in zip(*outs))
    return duffs, Ks, jnp.sum(dv1), jnp.sum(dv2)


@functools.lru_cache(maxsize=None)
def jax_reference(n, m, symmetrize, T=T, B=B):
    """The inputs and the JAX recursion's outputs, batch-last."""

    models = synthetic_models(n, m, B, T, seed=7 * n + m)
    reg = np.array([1e-3, 1.0])[:B]
    lanes = [jax_scan_lane(*(a[..., b] for a in models), float(reg[b]),
                           symmetrize) for b in range(B)]
    ref = tuple(np.stack([np.asarray(lane[k]) for lane in lanes], axis=-1)
                for k in range(4))
    return models, reg, ref


def hold(port, ref):
    for name, p, r in zip(NAMES, port, ref):
        p = to_numpy(p)
        assert p.shape == r.shape, (name, p.shape, r.shape)
        err = np.abs(p - r).max() / np.abs(r).max()
        assert err <= RTOL, (name, err)


def check_against_jax_scan(n, m, symmetrize, T=T, B=B):
    assert cuda_riccati.route(n, m) == ("riccati_xl", n, m)
    models, reg, ref = jax_reference(n, m, symmetrize, T, B)
    tm = tuple(to_torch(a) for a in models)
    treg = to_torch(reg)
    port = riccati_scan_cuda_bl(*tm, treg, symmetrize=symmetrize)
    hold(port, ref)
    bf = riccati_scan_cuda_batched(
        *(x.movedim(-1, 0).contiguous() for x in tm), treg,
        symmetrize=symmetrize)
    # The batch-first entry is the same recursion on moved axes.
    for a, b in zip(bf, from_batch_last(port)):
        assert torch.equal(a, b)
    hold(tuple(x.movedim(0, -1) for x in bf[:2]) + bf[2:], ref)


@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("n,m", SHAPES)
def test_plain_past_the_large_plan_matches_the_jax_scan(n, m, symmetrize):
    check_against_jax_scan(n, m, symmetrize)


def test_the_new_source_is_built_at_first_use():
    src, flags = _build._source_and_flags("riccati_xl_36x18_f32")
    assert src.name == "riccati_xl.cu"
    assert flags[-3:] == ("-DRICCATI_N=36", "-DRICCATI_M=18",
                          "-DRICCATI_SCALAR=float")
    assert flags[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
    src, flags = _build._source_and_flags("riccati_xl_64x32_f64_clocks")
    assert src.name == "riccati_xl.cu"
    assert flags[-2:] == ("-DRICCATI_SCALAR=double", "-DRICCATI_STAGE_CLOCKS")
    # Like riccati_large.cu, it has no fixed library of its own.
    assert "riccati_xl" not in _build.SOURCES
    assert "riccati_xl" in _build.INSTANCE_SOURCES
    assert _build.instance("riccati_xl", 36, 18, "f64") == "riccati_xl_36x18_f64"
    assert cuda_riccati.library_and_symbol(36, 18, torch.float32) == (
        "riccati_xl_36x18_f32", "riccati_cuda_instance")
    assert cuda_riccati.kernel_name(64, 32, torch.float64) == (
        "riccati_cuda_64x32_f64")


def test_the_new_source_host_interface():
    # (Its stage-clock names: tests/test_torch_riccati_large.py.)
    text = (_build.CSRC / "riccati_xl.cu").read_text()
    # Its ceiling is the router's.
    (n_max, m_max) = re.findall(r"constexpr int kMaxN = (\d+), kMaxM = (\d+);",
                                text)[0]
    assert (int(n_max), int(m_max)) == cuda_riccati.XL_MAX == (64, 32)
    # The copy path it reports: plain loads where the inputs lie.
    (path,) = re.findall(r"constexpr int kPathDirect = (\d+);", text)
    assert cuda_riccati.COPY_PATHS[int(path)] == "direct"


@pytest.mark.gpu
def test_xl_shapes_on_the_card():
    """Needs the card: the new instantiations against the plain version,
    float64, both entries bit-equal, launches counted."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for n, m in CARD_SHAPES:
        models = tuple(to_torch(a).cuda()
                       for a in synthetic_models(n, m, 5, 7, seed=n))
        name = cuda_riccati.kernel_name(n, m, torch.float64)
        before = cuda_riccati.launch_counts.get(name, 0)
        out = riccati_scan_cuda_bl(*models, 1e-2)
        assert cuda_riccati.launch_counts[name] == before + 1
        assert cuda_riccati.last_launch["copy_path"] == "direct"
        want = riccati_scan_plain_bl(*models, 1e-2)
        for o, w in zip(out, want):
            torch.testing.assert_close(o, w, rtol=1e-10, atol=1e-12)
        bf = riccati_scan_cuda_batched(
            *(x.movedim(-1, 0).contiguous() for x in models), 1e-2)
        for a, b in zip(from_batch_last(out), bf):
            assert torch.equal(a, b)
