"""The Riccati kernel past ``(64, 32)``, up to ``(128, 64)``: the shapes that
``csrc/riccati_cluster.cu`` runs on the card, a cluster of blocks a lane,
float64, CPU.

* The plain version, through both entries (``riccati_scan_cuda_bl`` and
  ``riccati_scan_cuda_batched`` on CPU tensors), at ``(65, 32)`` (a 26-joint
  humanoid under ``al_solve``) and ``(72, 36)`` (the free-flying five-arm),
  B=2, T=2, with ``symmetrize`` on and off, against the JAX
  ``backward.riccati_step`` run eagerly over t = T-1 ... 0 from the
  terminal carry, its dv terms summed: each output within 1e-10 of its
  largest magnitude.  The other shapes are held the same way, a file each
  so that each file stays under half a minute:
  ``tests/test_torch_riccati_cluster_al.py`` (``(73, 36)``),
  ``_wide.py`` (``(20, 40)``), ``_96.py`` (``(96, 48)``), ``_ceiling.py``
  and ``_ceiling_raw.py`` (``(128, 64)``, ``symmetrize`` on and off).  As
  in ``tests/test_torch_riccati_xl.py``, neither the Pallas interpreter
  nor a compiled scan runs here (``ROADMAP.md`` C9: minutes at these
  shapes); the JAX step runs on both lanes at once, its arrays carrying
  the batch on a leading axis (``jax_scan``), so that each of its eager
  operations serves both lanes.
* The host side of the new source: its build flags and its stage-clock
  build, its ceiling, the routing, the copy paths and the blocks a lane its
  launcher reports, and the cluster size and panel rows its plan takes at
  each shape and type (the shared-memory arithmetic written out again in
  :func:`cluster_plan`).  ``chip_smoke.py --cluster-times`` times every row
  of this source.
* The kernel itself on the card (marked ``gpu``; skips here).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.backward import riccati_step
import chip_smoke
from ilqr_tpu_torch.ops import _build, cuda_riccati
from ilqr_tpu_torch.ops.cuda_riccati import (from_batch_last,
                                             riccati_scan_cuda_batched,
                                             riccati_scan_cuda_bl,
                                             riccati_scan_plain_bl)
from tests.test_torch_riccati_shapes import synthetic_models
from tests.torch_parity import to_numpy, to_torch

torch.set_num_threads(1)

NAMES = ("duffs", "Ks", "dv1", "dv2")
B, T = 2, 2
RTOL = 1e-10
# Every shape this file and its siblings hold, for the card's test.
CARD_SHAPES = [(65, 32), (72, 36), (73, 36), (20, 40), (96, 48), (128, 64)]


def jax_scan(models, reg, symmetrize):
    """``riccati_scan``'s recursion on batch-last numpy ``models``: its
    ``backward.riccati_step`` over t = T-1 ... 0 from the terminal carry,
    the dv terms summed over t, run eagerly with the lanes on a leading
    axis; returns batch-last outputs."""

    As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN = (
        jnp.asarray(np.moveaxis(a, -1, 0)) for a in models)
    lanes = As.shape[0]
    carry = (jnp.zeros(lanes), qxN, QN)
    outs = [None] * As.shape[1]
    for t in reversed(range(As.shape[1])):
        inp = (As[:, t], Bs[:, t], jnp.zeros(lanes), qx[:, t], ru[:, t],
               Qxx[:, t], Pux[:, t], Ruu[:, t])
        carry, outs[t] = riccati_step(
            carry, inp, reg=jnp.asarray(reg)[:, None, None],
            symmetrize=symmetrize)
    duffs, Ks, dv1, dv2 = (jnp.stack(o, axis=1) for o in zip(*outs))
    return (np.moveaxis(np.asarray(duffs), 0, -1),
            np.moveaxis(np.asarray(Ks), 0, -1),
            np.asarray(dv1).sum(axis=1), np.asarray(dv2).sum(axis=1))


@functools.lru_cache(maxsize=None)
def jax_reference(n, m, symmetrize):
    """The inputs, ``reg`` and the JAX recursion's outputs, batch-last."""

    models = synthetic_models(n, m, B, T, seed=7 * n + m)
    reg = np.array([1e-3, 1.0])
    return models, reg, jax_scan(models, reg, symmetrize)


def hold(port, ref):
    for name, p, r in zip(NAMES, port, ref):
        p = to_numpy(p)
        assert p.shape == r.shape, (name, p.shape, r.shape)
        err = np.abs(p - r).max() / np.abs(r).max()
        assert err <= RTOL, (name, err)


def check_against_jax(n, m, symmetrize):
    assert cuda_riccati.route(n, m) == ("riccati_cluster", n, m)
    models, reg, ref = jax_reference(n, m, symmetrize)
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
@pytest.mark.parametrize("n,m", [(65, 32), (72, 36)])
def test_plain_past_the_xl_plan_matches_the_jax_step(n, m, symmetrize):
    check_against_jax(n, m, symmetrize)


def up(x, to):
    return -(-x // to) * to


def cluster_plan(n, m, size, C, kp):
    """Bytes a block of ``riccati_cluster.cu``'s Plan at ``(n, m)`` in
    values of ``size`` bytes, for a cluster of ``C`` blocks with A and B
    resident (``kp = 0``) or streamed in panels of ``kp`` rows: its
    shared-memory arithmetic, written out again so that the card's test can
    hold the source to it.  ``None`` where ``kp`` rows do not divide the
    padded n."""

    NP, MP = up(n, 4), up(m, 4)
    if kp and NP % kp:
        return None
    R, RM = up(-(-n // C), 4), up(-(-m // C), 4)
    vec = 16 // size
    LR, LRM, LG, LHT = R + vec, RM + vec, R + 4, MP + vec
    # Sk, Sc, S A's and P's column panels, S'B's; [G | g], [K | duff],
    # [W | H duff]; H' with L and the pivots, or a peer's G, K, W and P
    # rows; the first terms (Qxx, Pux, Ruu, qx, ru); s, qx + A's and four
    # scalars; the ring of A and B; then its two mbarriers (16 bytes) and
    # the stage clocks' nine counters with a spare (80 bytes).
    values = (4 * NP * LR + NP * LRM + 3 * MP * LG
              + max(MP * LHT + up(m * (m + 1) // 2, 4) + MP,
                    3 * MP * LG + R * LR)
              + NP * LR + RM * NP + RM * MP + up(R + MP, 4) + NP + R + 4
              + (NP * (NP + MP) if kp == 0 else 2 * kp * (NP + MP)))
    return values * size + 16 + 80


def copy_path(n, m, kp, layout):
    """The copy path the launcher reports: batch-first where the rows of A
    and B have no pad (n and m multiples of 4), the bulk copies; else the
    packer warps with A and B resident (``kp = 0``) or streamed."""

    if layout == cuda_riccati.BATCH_FIRST and n % 4 == 0 and m % 4 == 0:
        return "bulk_copy"
    return "packer_staged" if kp == 0 else "panel_stream"


def cluster_size(n, m, dtype):
    """``(C, bytes a block, panel rows)``: the fewest of 2, 4, 8 blocks
    whose share of the step fits a block's 232,448 bytes, with A and B
    resident (0) where they fit, else in panels of the most of 32, 16, 8, 4
    rows that fit, as the source picks them."""

    size = torch.empty((), dtype=dtype).element_size()
    for C in (2, 4, 8):
        for kp in (0, 32, 16, 8, 4):
            nbytes = cluster_plan(n, m, size, C, kp)
            if nbytes is not None and nbytes <= 232448:
                return C, nbytes, kp
    raise AssertionError(f"({n}, {m}) does not fit a cluster of 8")


def test_the_new_source_host_interface():
    src, flags = _build._source_and_flags("riccati_cluster_72x36_f32")
    assert src.name == "riccati_cluster.cu"
    assert flags[-3:] == ("-DRICCATI_N=72", "-DRICCATI_M=36",
                          "-DRICCATI_SCALAR=float")
    assert flags[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
    # Like riccati_xl.cu, no fixed library of its own; a stage-clock build
    # of each instantiation, its stages named where cuda_riccati reads
    # them.
    assert "riccati_cluster" not in _build.SOURCES
    assert "riccati_cluster" in _build.INSTANCE_SOURCES
    src, clock_flags = _build._source_and_flags(
        "riccati_cluster_72x36_f32_clocks")
    assert src.name == "riccati_cluster.cu"
    assert clock_flags == flags + ("-DRICCATI_STAGE_CLOCKS",)
    assert cuda_riccati.library_and_symbol(72, 36, torch.float64) == (
        "riccati_cluster_72x36_f64", "riccati_cuda_instance")
    text = (_build.CSRC / "riccati_cluster.cu").read_text()
    (stages,) = re.findall(r"constexpr int kStages = (\d+);", text)
    assert len(cuda_riccati.STAGES["riccati_cluster"]) == int(stages) == 8
    assert "#ifdef RICCATI_STAGE_CLOCKS" in text
    # Its ceiling is the router's.
    (n_max, m_max) = re.findall(
        r"constexpr int kMaxN = (\d+), kMaxM = (\d+);", text)[0]
    assert (int(n_max), int(m_max)) == cuda_riccati.CLUSTER_MAX == (128, 64)
    # The copy paths it reports, and the code of a plan that fits no card.
    (packers, panels) = re.findall(
        r"constexpr int kPathPackers = (\d+), kPathPanels = (\d+);", text)[0]
    assert cuda_riccati.COPY_PATHS[int(packers)] == "packer_staged"
    assert cuda_riccati.COPY_PATHS[int(panels)] == "panel_stream"
    (bulk,) = re.findall(r"constexpr int kPathBulk = (\d+);", text)
    assert cuda_riccati.COPY_PATHS[int(bulk)] == "bulk_copy"
    BL, BF = cuda_riccati.BATCH_LAST, cuda_riccati.BATCH_FIRST
    assert copy_path(72, 36, 0, BF) == copy_path(128, 64, 32, BF) == "bulk_copy"
    assert copy_path(72, 36, 0, BL) == copy_path(73, 36, 0, BF) == "packer_staged"
    assert copy_path(128, 64, 32, BL) == copy_path(65, 32, 4, BF) == "panel_stream"
    (none_fits,) = re.findall(r"constexpr int kNoClusterFits = (\d+);", text)
    assert int(none_fits) == cuda_riccati.NO_CLUSTER_FITS
    f32, f64 = torch.float32, torch.float64
    # Every shape past (64, 32) routes here, up to the ceiling; every shape
    # up to (64, 32) routes as before.
    for n, m in CARD_SHAPES + [(65, 1), (1, 33), (128, 64), (128, 1),
                               (1, 64)]:
        assert cuda_riccati.route(n, m) == ("riccati_cluster", n, m)
        for dtype, tag in ((f32, "f32"), (f64, "f64")):
            assert cuda_riccati.kernel_name(n, m, dtype) == (
                f"riccati_cuda_{n}x{m}_{tag}")
    for n, m in ((64, 32), (64, 1), (1, 32), (36, 18)):
        assert cuda_riccati.route(n, m) == ("riccati_xl", n, m)
    for n, m in ((129, 64), (128, 65), (129, 1), (1, 65)):
        with pytest.raises(NotImplementedError,
                           match=r"n <= 128 and m <= 64.*\(128, 64\).*scan"):
            cuda_riccati.route(n, m)
    # The cluster each plan takes: two blocks with A and B resident at the
    # five-arm's (72, 36) in float32; two with panels of 4 rows in float64;
    # (96, 48) float32 two blocks, panels of 32 rows; the ceiling four
    # blocks in float32 (panels of 32), eight in float64 (panels of 8).
    assert cluster_size(72, 36, f32) == (2, 145408, 0)
    assert cluster_size(72, 36, f64) == (2, 227936, 4)
    assert cluster_size(96, 48, f32) == (2, 232240, 32)
    assert cluster_size(96, 48, f64) == (4, 232448, 16)
    assert cluster_size(128, 64, f32) == (4, 224880, 32)
    assert cluster_size(128, 64, f64) == (8, 222848, 8)
    assert cluster_size(20, 40, f32) == (2, 36528, 0)
    # Every shape up to the ceiling fits a cluster of eight in both types.
    for n in range(1, 129):
        for m in range(1, 65):
            if n > 64 or m > 32:
                assert cluster_size(n, m, f64)[0] <= 8


def test_cluster_times_covers_every_row_of_the_source():
    """``chip_smoke.py --cluster-times`` times every shape of ``shapes``
    that routes to ``riccati_cluster.cu``, in both types (``shapes`` runs
    some in float32 only), and ``rbd_five``'s launch, (72, 36) float32 at
    B=64, T=50."""

    rows = chip_smoke.CLUSTER_TIMES
    routed = [(n, m) for n, m in chip_smoke.NEW_SHAPES
              if cuda_riccati.route(n, m)[0] == "riccati_cluster"]
    assert routed == [(72, 36), (128, 64), (65, 32), (73, 36), (20, 40),
                      (96, 48)]
    for n, m in routed:
        assert ((n, m), chip_smoke.SHAPES["B"], chip_smoke.shape_T(m),
                (torch.float32, torch.float64)) in rows
    five = ((72, 36), chip_smoke.DUAL["B"], chip_smoke.DUAL["T"],
            (torch.float32,))
    assert five in rows and (five[1], five[2]) == (64, 50)
    assert len(rows) == len(routed) + 1
    # Every row routes to the source.
    assert all(cuda_riccati.route(*shape)[0] == "riccati_cluster"
               for shape, _, _, _ in rows)


@pytest.mark.gpu
def test_cluster_shapes_on_the_card():
    """Needs the card: the instantiations against the plain version, both
    types (float64 to rtol 1e-10, float32 within 5e-5 of each output's
    largest magnitude, chip_smoke.py's bars), both entries bit-equal, at a
    ragged and a whole batch; launches counted, the copy path, the blocks a
    lane and the shared bytes those of the plan; the copy path of each
    entry the one of the plan (:func:`copy_path`: batch-first at n and m
    multiples of 4, ``bulk_copy``; else A and B resident,
    ``packer_staged``, or streamed in panels, ``panel_stream``)."""

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for n, m in CARD_SHAPES:
        for dtype in (torch.float64, torch.float32):
            C, nbytes, kp = cluster_size(n, m, dtype)
            for lanes in (5, 8):
                models = tuple(
                    to_torch(a).to(dtype).cuda()
                    for a in synthetic_models(n, m, lanes, 3, seed=n + lanes))
                name = cuda_riccati.kernel_name(n, m, dtype)
                before = cuda_riccati.launch_counts.get(name, 0)
                out = riccati_scan_cuda_bl(*models, 1e-2)
                assert cuda_riccati.launch_counts[name] == before + 1
                assert cuda_riccati.last_launch["copy_path"] == copy_path(
                    n, m, kp, cuda_riccati.BATCH_LAST)
                assert cuda_riccati.last_launch["cluster_size"] == C
                want = riccati_scan_plain_bl(*models, 1e-2)
                for o, w in zip(out, want):
                    if dtype == torch.float64:
                        torch.testing.assert_close(o, w, rtol=1e-10,
                                                   atol=1e-12)
                    else:
                        assert torch.isfinite(o).all()
                        err = (o - w).abs().max() / w.abs().max()
                        assert float(err) <= 5e-5, (n, m, lanes, float(err))
                bf = riccati_scan_cuda_batched(
                    *(x.movedim(-1, 0).contiguous() for x in models), 1e-2)
                assert cuda_riccati.last_launch["copy_path"] == copy_path(
                    n, m, kp, cuda_riccati.BATCH_FIRST)
                for a, b in zip(from_batch_last(out), bf):
                    assert torch.equal(a, b)
            library = cuda_riccati.library_and_symbol(n, m, dtype)[0]
            lib = _build.load(library)
            assert lib.riccati_cuda_instance_shared_bytes() == nbytes
            assert lib.riccati_cuda_instance_cluster_size() == C
