"""The fused backward Riccati recursion: CUDA kernel, wrapper, plain version.

Counterpart of ``ilqr_tpu/ops/pallas_riccati.py`` (its batch-last entry
``riccati_scan_pallas_bl`` and its batch-first entry
``riccati_scan_pallas_batched``).  The kernel is written by hand for ``sm_90a``
in four designs — ``csrc/riccati.cu``, one thread a lane with a ring of
prefetched steps, for ``(n, m) = (4, 2)`` and ``(5, 2)`` (the 2-link arm
under ``al.al_solve``, whose state carries the step index);
``csrc/riccati_wide.cu``, a lane
spread over four warps with its matrices in shared memory and its inputs
brought in by TMA, for ``(16, 8)`` and ``(24, 12)``; ``csrc/riccati_large.cu``,
``csrc/riccati_xl.cu`` and ``csrc/riccati_cluster.cu`` for the shapes past
the wide plan (below; each source says why) — all
reading either layout in place, selected by a layout argument, built
at first use by :mod:`ilqr_tpu_torch.ops._build` and called through ctypes.
It has no gradient (the JAX kernel has none either), so there is no
``torch.autograd.Function`` around it.

Any other ``(n, m)``, as the Pallas kernel is specialized for whatever
shape reaches it, is an instantiation built at first use
(:func:`kernel_name`, :func:`route`): ``riccati.cu`` where ``n, m <= 5``
(one thread a lane, whose registers are nearly spent at ``(5, 2)``),
``riccati_wide.cu`` padded to ``(ceil(n/8)*8, ceil(m/4)*4)`` up to the
padded ``(24, 12)`` (:data:`WIDE_MAX`, where its plan of two lanes a block
ends), ``csrc/riccati_large.cu`` past that — one lane a block at the
logical shape, unpadded — up to ``n <= 32``, ``m <= 16`` (:data:`LARGE_MAX`),
and ``csrc/riccati_xl.cu`` past that — one lane a block, the inputs
staged in shared memory or carried in registers a step ahead — up to ``n <=
64``, ``m <= 32``
(:data:`XL_MAX`, where one lane's step fills a block: the free-flying dual
arm's ``(36, 18)`` and a humanoid's ``(64, 32)``), and
``csrc/riccati_cluster.cu`` past that — one lane a thread-block cluster of
2, 4 or 8 blocks that split its rows and store what a peer reads into the
peer's shared memory — up to ``n <= 128``, ``m <= 64``
(:data:`CLUSTER_MAX`, the largest shape held on the card: the free-flying
five-arm's ``(72, 36)``, a humanoid under ``al_solve`` at ``(65, 32)``).  A
larger shape raises before any ``nvcc`` run.

* :func:`riccati_scan_cuda_bl` — the wrapper.  On CUDA tensors it launches
  the kernel or raises; on CPU tensors it takes the plain version.  It
  never falls back from one to the other.
* :func:`riccati_scan_cuda_batched` — the batch-first entry (counterpart of
  ``riccati_scan_pallas_batched``, which the per-scenario solver reaches
  when it is batched): the same kernels read ``[B, T, ...]`` inputs and
  write batch-first outputs, with no layout copy.  The arithmetic of a lane
  is the same in both layouts, so the two entries agree bit for bit.  Its
  launches are counted apart (:data:`batched_launch_counts`).
* :data:`last_launch` — the kernel, layout, copy path and blocks a lane
  (``cluster_size``) of the last launch, as the library reports them.
* :func:`riccati_stage_clocks` — cycles a step by stage, from a second
  build of a source with ``-DRICCATI_STAGE_CLOCKS`` (never on the main
  path).
* :func:`riccati_scan_plain_bl`, :func:`riccati_scan_plain_batched` — the
  same algebra step by step in PyTorch (Python loop over ``t``, one
  ``rsqrt`` per Cholesky pivot as in the kernel).  The CPU tests use them
  and the card check holds the kernel against them.
* :func:`riccati_loop_bl` — the loop both the plain version and
  ``batched.riccati_bl_scan`` (``sqrt`` then divide, the ``"scan"``
  backend) run; they differ only in the factorization they hand it.

Shapes of the batch-last entry: ``As [T,n,n,B] Bs [T,n,m,B] qx [T,n,B] ru [T,m,B]
Qxx [T,n,n,B] Pux [T,m,n,B] Ruu [T,m,m,B] qxN [n,B] QN [n,n,B]``, ``reg``
scalar or ``[B]``; returns ``(duffs [T,m,B], Ks [T,m,n,B], dv1 [B],
dv2 [B])`` with ``dv1 = sum_t duff.g`` and ``dv2 = 1/2 sum_t duff.H.duff``.

Float32 agreement of kernel and plain version: both use ``rsqrt`` and the
same formulas, but the compiler contracts the kernel's multiply-adds into
fused multiply-adds (one rounding instead of two) and sums in another
order, and the recursion carries that rounding through T steps.  The card
check therefore states a float32 bound of 5e-5 relative to each output's
largest magnitude; in float64 the two agree to rtol 1e-10.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from ilqr_tpu_torch.ops import smallmat as sm

# (n, m, dtype) -> exported launcher of the sources' fixed instantiations.
KERNELS: Dict[Tuple[int, int, torch.dtype], str] = {
    (4, 2, torch.float32): "riccati_cuda_4x2_f32",
    (4, 2, torch.float64): "riccati_cuda_4x2_f64",
    # The 2-link arm with the augmented Lagrangian's index coordinate.
    (5, 2, torch.float32): "riccati_cuda_5x2_f32",
    (5, 2, torch.float64): "riccati_cuda_5x2_f64",
    (16, 8, torch.float32): "riccati_cuda_16x8_f32",
    (16, 8, torch.float64): "riccati_cuda_16x8_f64",
    (24, 12, torch.float32): "riccati_cuda_24x12_f32",
    (24, 12, torch.float64): "riccati_cuda_24x12_f64",
}

# Launcher -> the source (csrc/<name>.cu) that exports it.
LIBRARY: Dict[str, str] = {
    name: "riccati" if key[:2] in ((4, 2), (5, 2)) else "riccati_wide"
    for key, name in KERNELS.items()
}
# The exported launcher of an instantiation library.
INSTANCE_SYMBOL = "riccati_cuda_instance"
_TAGS = {torch.float32: "f32", torch.float64: "f64"}

# riccati.cu takes a shape whose n and m are at most this.
ONE_THREAD_MAX = 5
# The largest padded (N, M) riccati_wide.cu serves: two lanes a block and
# one warp for the N + 1 column solves end its plan there.
WIDE_MAX = (24, 12)
# The largest (n, m) riccati_large.cu serves, unpadded (its plan's
# static_asserts own the exact limit).
LARGE_MAX = (32, 16)
# The largest (n, m) riccati_xl.cu serves, unpadded.  There a lane's step
# fills one block's shared memory (204,672 of 232,448 bytes in float64); a
# larger lane takes a cluster of blocks.
XL_MAX = (64, 32)
# The largest (n, m) riccati_cluster.cu serves: the largest shape held on the
# card.  Its lane is a cluster of the fewest of 2, 4, 8 blocks whose share of
# the step fits a block (its Plan): at (128, 64) 187,920 bytes a block of 4 in
# float32, 222,752 a block of 8 in float64.
CLUSTER_MAX = (128, 64)

# Launches per kernel name: one is added where a wrapper launches the
# kernel, and nowhere else — by the batch-last entry to ``launch_counts``,
# by the batch-first entry to ``batched_launch_counts`` (a name built at
# first use enters both at its first launch).
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS.values()}
batched_launch_counts: Dict[str, int] = {name: 0 for name in KERNELS.values()}

# The layout argument of the kernels.
BATCH_LAST, BATCH_FIRST = 0, 1

# The copy paths a launcher reports: riccati_wide.cu takes TMA where every
# input allows it, else copies per element; riccati.cu copies a value at a
# time batch-last and 16 bytes at a time batch-first; riccati_large.cu one
# 1-D bulk copy (the TMA engine, path 1) an input and step batch-first (it
# refuses inputs that do not start on 16 bytes: as_kernel_input aligns
# them), a value at a time batch-last; riccati_xl.cu fills a ring of two
# slots beside its plan where one fits (path 1: batch-first the bulk copy,
# where the ring also costs no block an SM; batch-last TMA boxes of 16 bytes
# of lanes), else carries each thread's first terms a step ahead in
# registers (path 4, also batch-last when a row of B lanes is not whole
# 16-byte granules); riccati_cluster.cu has its packer warps stage the next
# step's first terms and, where they fit beside the plan, its whole A and B
# in shared memory while the step before factors (path 5), else streams A
# and B in panels of rows, each loaded into registers while the panel
# before is summed (path 6); batch-first, where the rows of A and B have no
# pad (n and m multiples of 4), A and B come by the bulk-copy engine instead,
# the whole step or a panel ahead, into the same ring (path 7; it refuses
# inputs that do not start on 16 bytes, as riccati_large.cu does).
COPY_PATHS = {0: "per_element", 1: "tma", 2: "vector16", 4: "register_prefetch",
              5: "packer_staged", 6: "panel_stream", 7: "bulk_copy"}
# What riccati_cluster.cu's launcher returns when no cluster of its plan
# fits on the card.
NO_CLUSTER_FITS = 10000

# Kernel name, layout and copy path of the last launch (either entry, or
# the stage-clock build).
last_launch: Dict[str, object] = {}


def launches() -> int:
    """Total kernel launches made by both entries."""

    return sum(launch_counts.values()) + sum(batched_launch_counts.values())


def reset_launch_counts() -> None:
    for counts in (launch_counts, batched_launch_counts):
        for name in counts:
            counts[name] = 0


def route(n: int, m: int) -> Tuple[str, int, int]:
    """``(source, N, M)``: the source that runs ``(n, m)`` and the shape it
    runs it at (padded in ``riccati_wide.cu``).  Raises
    ``NotImplementedError`` for a shape no source serves, before any
    ``nvcc`` run."""

    if n < 1 or m < 1:
        raise ValueError(f"(n, m) = ({n}, {m}) is not a shape")
    if n <= ONE_THREAD_MAX and m <= ONE_THREAD_MAX:
        return "riccati", n, m
    N, M = -(-n // 8) * 8, -(-m // 4) * 4
    if N <= WIDE_MAX[0] and M <= WIDE_MAX[1]:
        return "riccati_wide", N, M
    if n <= LARGE_MAX[0] and m <= LARGE_MAX[1]:
        return "riccati_large", n, m
    if n <= XL_MAX[0] and m <= XL_MAX[1]:
        return "riccati_xl", n, m
    if n > CLUSTER_MAX[0] or m > CLUSTER_MAX[1]:
        raise NotImplementedError(
            f"the fused Riccati kernel serves n <= {CLUSTER_MAX[0]} and m <= "
            f"{CLUSTER_MAX[1]}: (n, m) = ({n}, {m}) is past the largest shape "
            f"served, {CLUSTER_MAX} in riccati_cluster.cu, a cluster of 2 to "
            f"8 blocks a lane; use backward_backend='scan'")
    return "riccati_cluster", n, m


def kernel_name(n: int, m: int, dtype: torch.dtype) -> str:
    """The launcher for ``(n, m, dtype)``: a fixed instantiation of
    :data:`KERNELS` or ``riccati_cuda_<n>x<m>_<f32|f64>``, an instantiation
    built at first use.  Raises for a type other than float32 and float64
    and (:func:`route`) for a shape no source serves."""

    if dtype not in _TAGS:
        raise NotImplementedError(
            f"the fused Riccati kernel takes float32 and float64, not {dtype}")
    fixed = KERNELS.get((n, m, dtype))
    if fixed is not None:
        return fixed
    route(n, m)
    return f"riccati_cuda_{n}x{m}_{_TAGS[dtype]}"


def library_and_symbol(n: int, m: int, dtype: torch.dtype) -> Tuple[str, str]:
    """``(library, exported launcher)`` of the kernel for ``(n, m, dtype)``:
    a source and a fixed launcher of :data:`KERNELS`, or an instantiation
    library and its generic launcher."""

    name = kernel_name(n, m, dtype)
    if name in LIBRARY:
        return LIBRARY[name], name
    from ilqr_tpu_torch.ops import _build

    return (_build.instance(route(n, m)[0], n, m, _TAGS[dtype]),
            INSTANCE_SYMBOL)


def _library(library: str):
    from ilqr_tpu_torch.ops import _build

    return _build.load(library)


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
             + [ctypes.c_void_p] * 2)


def _launcher(symbol: str, library: str):
    fn = getattr(_library(library), symbol)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _shapes(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, layout):
    """``(T, n, m, B)`` of a set of inputs in ``layout``; raises on a
    shape that does not fit it."""

    if As.ndim != 4 or Bs.ndim != 4:
        raise ValueError("As and Bs must be 4-d, got "
                         f"{tuple(As.shape)} and {tuple(Bs.shape)}")
    if layout == BATCH_LAST:
        T, n, _, B = As.shape
        m = Bs.shape[2]
        want = {"As": (T, n, n, B), "Bs": (T, n, m, B), "qx": (T, n, B),
                "ru": (T, m, B), "Qxx": (T, n, n, B), "Pux": (T, m, n, B),
                "Ruu": (T, m, m, B), "qxN": (n, B), "QN": (n, n, B)}
        kind = "batch-last"
    else:
        B, T, n, _ = As.shape
        m = Bs.shape[3]
        want = {"As": (B, T, n, n), "Bs": (B, T, n, m), "qx": (B, T, n),
                "ru": (B, T, m), "Qxx": (B, T, n, n), "Pux": (B, T, m, n),
                "Ruu": (B, T, m, m), "qxN": (B, n), "QN": (B, n, n)}
        kind = "batch-first"
    for (name, shape), x in zip(want.items(),
                                (As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN)):
        if tuple(x.shape) != shape:
            raise ValueError(
                f"{name} must be {shape} ({kind}), got {tuple(x.shape)}")
    return T, n, m, B


def _launch(arrays, reg, symmetrize, layout, clocks=None):
    """Launch the kernel on CUDA ``arrays`` in ``layout``, contiguous;
    returns ``(launcher name, (duffs, Ks, dv1, dv2))`` in the same layout.
    With ``clocks`` (an int64 tensor ``[B, stages]``) the stage-clock build
    of the source runs instead, uncounted."""

    As = arrays[0]
    T, n, m, B = _shapes(*arrays, layout)
    if any(x.device != As.device or x.dtype != As.dtype for x in arrays):
        raise ValueError("all inputs must share one device and one dtype")
    if As.device.type != "cuda":
        raise ValueError(f"unsupported device {As.device}")
    name = kernel_name(n, m, As.dtype)
    for x in arrays:
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")

    reg_b = torch.as_tensor(reg, dtype=As.dtype, device=As.device)
    if reg_b.shape != (B,) or not reg_b.is_contiguous():
        reg_b = reg_b.expand(B).contiguous()
    kw = dict(dtype=As.dtype, device=As.device)
    if layout == BATCH_LAST:
        duffs, Ks = torch.empty((T, m, B), **kw), torch.empty((T, m, n, B), **kw)
    else:
        duffs, Ks = torch.empty((B, T, m), **kw), torch.empty((B, T, m, n), **kw)
    dv1, dv2 = torch.empty((B,), **kw), torch.empty((B,), **kw)

    # The copy path, then the blocks a lane (riccati_cluster.cu alone
    # writes the second: the other sources run a lane in one block).
    path = (ctypes.c_int * 2)(-1, 1)
    library, symbol = library_and_symbol(n, m, As.dtype)
    library += "_clocks" if clocks is not None else ""
    fn = _launcher(symbol, library)
    ptrs = (ctypes.c_void_p * 7)(*(x.data_ptr() for x in arrays[:7]))
    with torch.cuda.device(As.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptrs, arrays[7].data_ptr(), arrays[8].data_ptr(),
                 reg_b.data_ptr(), duffs.data_ptr(), Ks.data_ptr(),
                 dv1.data_ptr(), dv2.data_ptr(), T, B, int(bool(symmetrize)),
                 layout, path,
                 None if clocks is None else clocks.data_ptr(), stream)
    if err == NO_CLUSTER_FITS:
        fn = _library(library)
        raise RuntimeError(
            f"{name}: no cluster of {fn.riccati_cuda_instance_cluster_size()} "
            f"blocks of {fn.riccati_cuda_instance_shared_bytes()} bytes of "
            f"shared memory fits on {torch.cuda.get_device_name(As.device)} "
            f"((n, m) = ({n}, {m}))")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    last_launch.update(kernel=name, layout=layout,
                       copy_path=COPY_PATHS[path[0]], cluster_size=path[1])
    return name, (duffs, Ks, dv1, dv2)


def riccati_scan_cuda_bl(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                         symmetrize: bool = True):
    """The whole backward recursion of a batch in one kernel launch.

    CUDA tensors: launches the kernel for ``(n, m)`` on the current stream (no
    synchronize) or raises — on a missing ``(n, m)`` instantiation
    (``NotImplementedError``), on a wrong device, dtype, shape or a
    non-contiguous input, on a failed build, on a refused launch.  CPU
    tensors: :func:`riccati_scan_plain_bl`.
    """

    arrays = (As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN)
    _shapes(*arrays, BATCH_LAST)
    if any(x.device != As.device or x.dtype != As.dtype for x in arrays):
        raise ValueError("all inputs must share one device and one dtype")
    if As.device.type == "cpu":
        # Any (n, m): the plain version is not instantiated.
        return riccati_scan_plain_bl(*arrays, reg, symmetrize=symmetrize)
    name, outs = _launch(arrays, reg, symmetrize, BATCH_LAST)
    launch_counts[name] = launch_counts.get(name, 0) + 1
    return outs


def to_batch_last(arrays):
    """Batch-first inputs ``[B, T, ...]`` / ``[B, ...]`` as contiguous
    batch-last tensors ``[T, ..., B]``: one copy of every input."""

    return tuple(x.movedim(0, -1).contiguous() for x in arrays)


def from_batch_last(outs):
    """The recursion's batch-last outputs ``(duffs [T,m,B], Ks [T,m,n,B],
    dv1 [B], dv2 [B])`` as batch-first views ``([B,T,m], [B,T,m,n], [B],
    [B])``, without a copy."""

    duffs, Ks, dv1, dv2 = outs
    return duffs.movedim(-1, 0), Ks.movedim(-1, 0), dv1, dv2


def as_kernel_input(x):
    """``x`` itself when it is contiguous and 16-byte aligned, as every
    tensor PyTorch allocates is; else a contiguous, aligned copy (a view
    with an offset, an expanded constant)."""

    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def riccati_scan_cuda_batched(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                              symmetrize: bool = True):
    """The batch-first entry: the same recursion on ``As [B, T, n, n]``,
    ``Bs [B, T, n, m]``, ``qx [B, T, n]``, ``ru [B, T, m]``, ``Qxx [B, T,
    n, n]``, ``Pux [B, T, m, n]``, ``Ruu [B, T, m, m]``, ``qxN [B, n]``,
    ``QN [B, n, n]``, ``reg`` scalar or ``[B]``; returns contiguous
    ``(duffs [B, T, m], Ks [B, T, m, n], dv1 [B], dv2 [B])``.

    CUDA tensors: the kernel reads the batch-first layout where it lies (a
    lane's step is a contiguous block of each input) and writes its outputs
    in it: no layout copy, nothing allocated beyond the outputs, unless an
    input is not contiguous and 16-byte aligned (:func:`as_kernel_input`)
    or ``reg`` is not a contiguous ``[B]`` tensor of the inputs' type.
    Launches or raises, as the batch-last wrapper does.  Unlike the JAX
    entry, the batch is not padded.  CPU tensors:
    :func:`riccati_scan_plain_batched`.
    """

    arrays = (As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN)
    if any(x.ndim < 2 or x.shape[0] != As.shape[0] for x in arrays):
        raise ValueError("inputs must share one leading batch axis "
                         f"(batch-first), got {[tuple(x.shape) for x in arrays]}")
    if As.device.type == "cpu":
        return riccati_scan_plain_batched(*arrays, reg, symmetrize=symmetrize)
    arrays = tuple(as_kernel_input(x) for x in arrays)
    name, outs = _launch(arrays, reg, symmetrize, BATCH_FIRST)
    batched_launch_counts[name] = batched_launch_counts.get(name, 0) + 1
    return outs


STAGES = {"riccati": ("copy_issue_wait", "smem_load", "gains", "value"),
          # Stage 3 split by warp 0's parts: the Cholesky, the solves, W and
          # H duff, the dv sums, then the wait for warps 1.. (A'(SA) and the
          # repack of the next step).
          "riccati_wide": ("BtS_SA", "G_H", "cholesky", "solves", "W_Hd", "dv",
                           "P_repack_wait", "copy_issue", "value"),
          # Seen from thread 0, a solver: stage 3 split by the solver
          # warps' parts, then the wait for warps 2-7 (P, the repack).
          "riccati_large": ("BtS_SA", "G_H", "cholesky", "solves", "W_Hd",
                            "P_repack_wait", "value"),
          # Seen from thread 0, a solver: stage 3 split by the solver
          # warps' parts, then the wait for the packer warps (P, the next
          # step's A and B).
          "riccati_xl": ("BtS_SA", "G_H", "cholesky", "solves", "W_Hd",
                         "P_load_wait", "value"),
          # Seen from thread 0 of block 0, a solver: stages 1 and 2 with
          # their cluster barriers; stage 3 split into the factor, the
          # solves, the wait for the packer warps' loads, then W, s and dv;
          # the pairs in the block's own rows up to the cluster wait, the
          # pairs across blocks up to the step's last cluster barrier.
          "riccati_cluster": ("BtS_SA", "G_H_P", "cholesky", "solves",
                              "loads_wait", "W_s_dv", "pairs_own",
                              "pairs_peer")}


def riccati_stage_clocks(arrays, reg, layout=BATCH_LAST):
    """Cycles a step by stage, from the source built with
    ``-DRICCATI_STAGE_CLOCKS`` (never on the main path, never counted):
    ``{stage: mean over the valid lanes of clock64() cycles / T}``, each
    stage ending where its last barrier lets the lane's thread 0 through."""

    T, n, m, B = _shapes(*arrays, layout)
    name = kernel_name(n, m, arrays[0].dtype)
    source = route(n, m)[0]
    if source not in STAGES:
        raise NotImplementedError(f"{name}: csrc/{source}.cu has no "
                                  "stage-clock build")
    stages = STAGES[source]
    clocks = torch.zeros((B, len(stages)), dtype=torch.int64,
                         device=arrays[0].device)
    _launch(arrays, reg, True, layout, clocks=clocks)
    per_step = clocks.double().mean(dim=0) / max(T, 1)
    return dict(zip(stages, per_step.tolist()))


def riccati_loop_bl(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                    symmetrize: bool, gains: Callable):
    """The backward recursion as a Python loop over ``t = T-1 … 0``.

    ``gains(H, reg, g, G) -> (duff, K)`` solves ``(H + reg I) x = -g`` and
    ``= -G``; the value update uses the raw ``H`` (the reference's mixed
    regularization, src/backward_pass.jl:186,214).
    """

    T = As.shape[0]
    s_vec, S = qxN, QN
    duffs, Ks = [None] * T, [None] * T
    dv1 = torch.zeros_like(qxN[0])
    dv2 = torch.zeros_like(qxN[0])
    for t in reversed(range(T)):
        A, B = As[t], Bs[t]
        BT_S = sm.mtm_bl(B, S)
        g = ru[t] + sm.mtv_bl(B, s_vec)
        G = Pux[t] + sm.mm_bl(BT_S, A)
        H = Ruu[t] + sm.mm_bl(BT_S, B)

        duff, K = gains(H, reg, g, G)

        H_duff = sm.mv_bl(H, duff)
        s_vec = (qx[t] + sm.mtv_bl(A, s_vec) + sm.mtv_bl(K, H_duff)
                 + sm.mtv_bl(K, g) + sm.mtv_bl(G, duff))
        KtG = sm.mtm_bl(K, G)
        S = (Qxx[t] + sm.mtm_bl(A, sm.mm_bl(S, A))
             + sm.mtm_bl(K, sm.mm_bl(H, K))
             + KtG + sm.transpose_bl(KtG))
        if symmetrize:
            S = 0.5 * (S + sm.transpose_bl(S))
        duffs[t], Ks[t] = duff, K
        dv1 = dv1 + sm.vv_bl(duff, g)
        dv2 = dv2 + 0.5 * sm.vv_bl(duff, H_duff)
    return torch.stack(duffs, dim=0), torch.stack(Ks, dim=0), dv1, dv2


def _gains_rsqrt(H, reg, g, G):
    L, inv_diag = sm.cholesky_rsqrt_bl(H, reg)
    return sm.cho_solve_gains_bl(L, g, G, inv_diag)


def riccati_scan_plain_bl(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                          symmetrize: bool = True):
    """The kernel's plain PyTorch version: same algebra, any device, any
    ``(n, m)``, one ``rsqrt`` per pivot and division-free solves."""

    return riccati_loop_bl(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                           symmetrize, _gains_rsqrt)


def riccati_scan_plain_batched(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,
                               symmetrize: bool = True):
    """The batch-first entry's plain version: the same layout moves around
    :func:`riccati_scan_plain_bl`."""

    arrays = (As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN)
    return from_batch_last(riccati_scan_plain_bl(
        *to_batch_last(arrays), reg, symmetrize=symmetrize))
