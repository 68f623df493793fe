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
  paths its launcher reports and which one its plan takes at each shape,
  layout and type (the shared-memory arithmetic written out again in
  :func:`xl_plan`), its instantiation names; ``chip_smoke.py --xl-times``'
  rows.
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


def up(x, to):
    return -(-x // to) * to


def xl_plan(n, m, size, layout, staged):
    """``(bytes, blocks an SM asked for)`` of ``riccati_xl.cu``'s Plan at
    ``(n, m)`` in values of ``size`` bytes, for a layout and copy path (the
    staging ring or registers): its shared-memory arithmetic, written out
    again so that the card's test can hold the source to it."""

    NP, MP = up(n, 8 if size == 8 else 4), up(m, 4)
    LDN = NP + 8 if (NP + 4) % 32 == 0 else NP + 4
    LDM, NA = MP + 4, LDN
    solvers = (n + 1 + 31) // 32
    lwarp = up(m * (m + 1) // 2, 4)
    # A, B, S, S' (float32), S A, S'B, W, K, G, H'; each solver warp's L in
    # the buffer of S'B where it fits; the reciprocal pivots, s, ys and
    # four scalars (reg, dv1, dv2).
    ht_end = (3 * NP * LDN + (0 if size == 8 else NP * LDN) + 2 * NP * LDM
              + 3 * MP * NA + MP * LDM)
    if solvers * lwarp > NP * LDM:
        ht_end += solvers * lwarp
    stage = up(ht_end + solvers * MP + 2 * NP + 4, 128 // size)
    vec = 16 // size
    E = (n * n, n * m, n, m, n * n, m * n, m * m)
    slot = sum(up(e + 2 * vec if layout == cuda_riccati.BATCH_FIRST
                  else e * vec, 128 // size) for e in E)
    nbytes = (stage + (2 * slot if staged else 0)) * size + (16 if staged else 0)
    blocks = (2 if layout == cuda_riccati.BATCH_FIRST
              and nbytes <= 233472 // 2 - 1024
              and m <= (16 if size == 8 else 24) else 1)
    return nbytes, blocks


def xl_copy_path(n, m, dtype, layout, B):
    """The copy path ``riccati_xl.cu``'s launcher takes: the staging ring
    where two slots fit beside the plan (batch-first, where they also cost
    no block an SM; batch-last, where a row of B lanes is whole 16-byte
    granules), else registers."""

    size = torch.empty((), dtype=dtype).element_size()
    staged, blocks = xl_plan(n, m, size, layout, True)
    _, prefetch_blocks = xl_plan(n, m, size, layout, False)
    ring = staged <= 232448
    if layout == cuda_riccati.BATCH_FIRST:
        ring = ring and blocks >= prefetch_blocks
    elif (B * size) % 16:
        ring = False
    return "tma" if ring else "register_prefetch"


def xl_shared_bytes(n, m, dtype):
    """What ``riccati_cuda_instance_shared_bytes`` reports: the larger of
    the two layouts' plans on their paths."""

    size = torch.empty((), dtype=dtype).element_size()
    return max(xl_plan(n, m, size, layout,
                       xl_copy_path(n, m, dtype, layout, 256) == "tma")[0]
               for layout in (cuda_riccati.BATCH_LAST,
                              cuda_riccati.BATCH_FIRST))


def test_the_new_source_host_interface():
    # (Its stage-clock names: tests/test_torch_riccati_large.py.)
    text = (_build.CSRC / "riccati_xl.cu").read_text()
    # Its ceiling is the router's.
    (n_max, m_max) = re.findall(r"constexpr int kMaxN = (\d+), kMaxM = (\d+);",
                                text)[0]
    assert (int(n_max), int(m_max)) == cuda_riccati.XL_MAX == (64, 32)
    # The copy paths it reports: the bulk-copy or TMA engine into the
    # staging ring, or registers.
    (tma, prefetch) = re.findall(
        r"constexpr int kPathTma = (\d+), kPathPrefetch = (\d+);", text)[0]
    assert cuda_riccati.COPY_PATHS[int(tma)] == "tma"
    assert cuda_riccati.COPY_PATHS[int(prefetch)] == "register_prefetch"
    BL, BF = cuda_riccati.BATCH_LAST, cuda_riccati.BATCH_FIRST
    f32, f64 = torch.float32, torch.float64
    # The staging ring batch-first wherever two slots fit, as at (36, 18)
    # and (64, 32) in float32, two lanes an SM at (36, 18) float32 ...
    for n, m, dtype in ((36, 18, f32), (36, 18, f64), (64, 32, f32),
                        (37, 18, f32), (33, 16, f32), (20, 32, f32)):
        assert xl_copy_path(n, m, dtype, BF, 256) == "tma", (n, m, dtype)
    assert xl_plan(36, 18, 4, BF, True) == (77328, 2)
    # ... batch-last, TMA boxes of 16 bytes of lanes (four lanes' values
    # in float32) wherever two slots of them fit, at one block an SM.
    assert xl_plan(36, 18, 4, BL, True) == (178960, 1)
    for n, m, dtype in ((36, 18, f32), (36, 18, f64), (37, 18, f32),
                        (33, 16, f32), (20, 32, f32)):
        assert xl_copy_path(n, m, dtype, BL, 256) == "tma", (n, m, dtype)
    assert xl_copy_path(36, 18, f32, BL, 64) == "tma"
    # A ragged batch-last row (B = 5 lanes of 4 bytes) takes registers.
    assert xl_copy_path(36, 18, f32, BL, 5) == "register_prefetch"
    assert xl_plan(36, 18, 4, BL, False) == (41984, 1)
    # (64, 32): no ring of boxes fits batch-last; in float64 no slot fits
    # beside its 204,672 bytes, so the registers carry the inputs in both
    # layouts.
    assert xl_copy_path(64, 32, f32, BL, 256) == "register_prefetch"
    assert xl_plan(64, 32, 8, BF, False) == (204672, 1)
    assert xl_plan(64, 32, 8, BF, True)[0] > 232448
    for layout in (BL, BF):
        assert xl_copy_path(64, 32, f64, layout, 256) == "register_prefetch"


@pytest.mark.gpu
def test_xl_shapes_on_the_card():
    """Needs the card: the instantiations against the plain version, both
    types (float64 to rtol 1e-10, float32 within 5e-5 of each output's
    largest magnitude, chip_smoke.py's bars), both entries bit-equal, at a
    ragged and a whole batch of 16-byte rows; launches counted, the copy
    paths and shared bytes those of the plan."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for n, m in CARD_SHAPES:
        for dtype in (torch.float64, torch.float32):
            for B in (5, 8):
                models = tuple(
                    to_torch(a).to(dtype).cuda()
                    for a in synthetic_models(n, m, B, 7, seed=n + B))
                name = cuda_riccati.kernel_name(n, m, dtype)
                before = cuda_riccati.launch_counts.get(name, 0)
                out = riccati_scan_cuda_bl(*models, 1e-2)
                assert cuda_riccati.launch_counts[name] == before + 1
                assert cuda_riccati.last_launch["copy_path"] == xl_copy_path(
                    n, m, dtype, cuda_riccati.BATCH_LAST, B)
                want = riccati_scan_plain_bl(*models, 1e-2)
                for o, w in zip(out, want):
                    if dtype == torch.float64:
                        torch.testing.assert_close(o, w, rtol=1e-10,
                                                   atol=1e-12)
                    else:
                        assert torch.isfinite(o).all()
                        err = (o - w).abs().max() / w.abs().max()
                        assert float(err) <= 5e-5, (n, m, B, float(err))
                bf = riccati_scan_cuda_batched(
                    *(x.movedim(-1, 0).contiguous() for x in models), 1e-2)
                assert cuda_riccati.last_launch["copy_path"] == xl_copy_path(
                    n, m, dtype, cuda_riccati.BATCH_FIRST, B)
                for a, b in zip(from_batch_last(out), bf):
                    assert torch.equal(a, b)
            library = cuda_riccati.library_and_symbol(n, m, dtype)[0]
            assert (_build.load(library).riccati_cuda_instance_shared_bytes()
                    == xl_shared_bytes(n, m, dtype))


def test_xl_times_covers_every_xl_shape():
    # chip_smoke.py --xl-times times every shape of phase shapes that
    # routes to riccati_xl.cu, in the types shapes runs it in, at shapes'
    # B and T, and rbd_dual's launch: (36, 18) float32, B=64, T=50.
    import chip_smoke

    rows = {(shape, B, T, types) for shape, B, T, types in chip_smoke.XL_TIMES}
    want = {((n, m), chip_smoke.SHAPES["B"],
             chip_smoke.SHAPES["T_m32"] if m == 32 else chip_smoke.SHAPES["T"],
             chip_smoke.shape_types(n, m))
            for n, m in chip_smoke.NEW_SHAPES
            if cuda_riccati.route(n, m)[0] == "riccati_xl"}
    assert len(want) == 5
    want.add(((36, 18), chip_smoke.DUAL["B"], chip_smoke.DUAL["T"],
              (torch.float32,)))
    assert rows == want
