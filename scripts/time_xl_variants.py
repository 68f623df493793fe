#!/usr/bin/env python3
"""Time the design choices of ``csrc/riccati_xl.cu`` against their
alternatives, on one GPU, in one process.

    python3 scripts/time_xl_variants.py [VARIANT ...]

Each variant is the source with one choice undone by a string replacement,
built with ``nvcc`` beside the source's own build (one ``nvcc`` a variant,
shape and type, all started together, into ``build/xl_variants/``) and
swapped in for the instantiation the wrapper loads
(``_build._loaded``):

* ``registers_batch_last``: batch-last carries the first terms in
  registers at two blocks an SM wherever shared memory allows, instead of
  TMA boxes at one block an SM.
* ``p_flipped``: P = Qxx + A'(SA) formed in the other stage (float32: in
  stage 3 where the source forms it in stage 2, and in stage 2 at
  ``(64, 32)``).
* ``pivot_after_shuffle``: the Cholesky's next pivot taken from the
  broadcast column, one shuffle more on a column's chain.
* ``indices_held``: the thread and batch indices not taken anew at every
  step (ptxas then holds the indices derived from them across the step
  loop).

For each of the shapes below and each variant (the source itself as
``source``): both entries' device time (``chip_smoke.device_time``, 20
calls, twice, in opposite orders of the variants), the cycles a step by
stage of both entries (the variant's stage-clock build), whether its
outputs equal the source's (``torch.equal``), the copy paths, and ``ptxas``'
registers and spills.  The source's outputs are held against the plain
version first.  One JSON line a shape, then one with the seconds.

It fails without a CUDA device; it imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ilqr_tpu_torch.ops import _build, cuda_riccati as cr  # noqa: E402

SOURCE = (_build.CSRC / "riccati_xl.cu").read_text()
# (old, new) replacements a variant makes; each old string must be found.
CHANGES = {
    "registers_batch_last": [
        ("Staged::FITS && (LAYOUT == BATCH_LAST || Staged::MINB >= Prefetch::MINB)",
         "Staged::FITS && Staged::MINB >= Prefetch::MINB"),
        ("LAYOUT == BATCH_FIRST && BYTES <= kTwoBlockBytes", "BYTES <= kTwoBlockBytes")],
    "p_flipped": [(" ==\n                 rounds(jobs2(pick(2, false)",
                   " !=\n                 rounds(jobs2(pick(2, false)")],
    "pivot_after_shuffle": [
        ("""        T d = a[0];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const T r = rsqrt_<T>(shfl(d, j));
          a[j] *= r;
          if (wl == 0) iw[j] = r;
          if (j + 1 < M) {
            d = a[j + 1];
            d -= a[j] * a[j];
          }
""", """#pragma unroll
        for (int j = 0; j < M; ++j) {
          const T r = rsqrt_<T>(shfl(a[j], j));
          a[j] *= r;
          if (wl == 0) iw[j] = r;
""")],
    "indices_held": [("""    tid = opaque(tid);
    warp = tid / 32;
    wl = tid % 32;
    b = opaque(b);
    in_box = (int)(b % BOX);
""", "")],
}
# (n, m), dtype, B, T; p_flipped only where float32 can form P in either
# stage (float64 forms it in stage 2).
SHAPES = (((36, 18), torch.float32, 256, 100), ((36, 18), torch.float32, 64, 50),
          ((36, 18), torch.float64, 256, 100), ((33, 16), torch.float32, 256, 100),
          ((64, 32), torch.float32, 256, 25), ((64, 32), torch.float64, 256, 25))
OUT = ROOT / "build" / "xl_variants"


def variant_text(name):
    text = SOURCE
    for old, new in CHANGES[name]:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer has {old[:60]!r}")
        text = text.replace(old, new)
    return text


def applies(name, dtype):
    return name != "p_flipped" or dtype == torch.float32


def build(names):
    """``{(variant, n, m, tag, clocks): path}``, every library built by one
    ``nvcc`` each, all at once; and ``ptxas``' lines a library."""

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(SOURCE if name == "source" else variant_text(name))
        for (n, m), dtype, _, _ in SHAPES:
            if not applies(name, dtype):
                continue
            tag = "f64" if dtype == torch.float64 else "f32"
            for clocks in (False, True):
                key = (name, n, m, tag, clocks)
                if key in procs:
                    continue
                lib = OUT / f"lib{name}_{n}x{m}_{tag}{'_clocks' if clocks else ''}.so"
                flags = list(_build.NVCC_FLAGS) + [
                    f"-DRICCATI_N={n}", f"-DRICCATI_M={m}",
                    f"-DRICCATI_SCALAR={'double' if tag == 'f64' else 'float'}"]
                if clocks:
                    flags.append("-DRICCATI_STAGE_CLOCKS")
                procs[key] = (lib, subprocess.Popen(
                    [_build.find_nvcc(), *flags, "-o", str(lib), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log[-4000:]}")
        libs[key] = lib
        if not key[-1]:
            ptxas[key] = sorted({re.sub(r"\s+", " ", ln.split(":", 1)[-1]).strip()
                                 for ln in log.splitlines()
                                 if "spill" in ln or "Used" in ln})
    return libs, ptxas


def main():
    if not torch.cuda.is_available():
        print("time_xl_variants: no CUDA device", file=sys.stderr)
        return 1
    names = ["source"] + (sys.argv[1:] or list(CHANGES))
    device = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    libs, ptxas = build(names)
    build_s = time.perf_counter() - t0
    for (n, m), dtype, B, T in SHAPES:
        tag = "f64" if dtype == torch.float64 else "f32"
        library = cr.library_and_symbol(n, m, dtype)[0]
        bl = cs.synthetic_models(n, m, B, T, 7 * n + m, device, dtype)
        bf = tuple(x.movedim(-1, 0).contiguous() for x in bl)
        reg = torch.logspace(-3, 0, B, dtype=dtype, device=device)
        ran = [v for v in names if applies(v, dtype)]
        rows, ref = {}, None
        for order in (ran, ran[::-1]):
            for name in order:
                _build._loaded[library] = ctypes.CDLL(str(libs[(name, n, m, tag, False)]))
                _build._loaded[library + "_clocks"] = ctypes.CDLL(
                    str(libs[(name, n, m, tag, True)]))
                out = cr.riccati_scan_cuda_bl(*bl, reg)
                path_bl = cr.last_launch["copy_path"]
                out_bf = cr.riccati_scan_cuda_batched(*bf, reg)
                path_bf = cr.last_launch["copy_path"]
                if ref is None:
                    cs.hold(out, cr.riccati_scan_plain_bl(*bl, reg), cs.F32_REL_BOUND)
                    ref = out
                row = rows.setdefault(name, dict(
                    batch_last_ms=[], batch_first_ms=[], paths=[path_bl, path_bf],
                    ptxas=ptxas[(name, n, m, tag, False)]))
                row["equal_to_source"] = all(
                    torch.equal(a, r) for a, r in zip(out, ref)) and all(
                    torch.equal(a, r) for a, r in zip(out_bf, cr.from_batch_last(ref)))
                row["batch_last_ms"].append(
                    cs.device_time(lambda: cr.riccati_scan_cuda_bl(*bl, reg), 20))
                row["batch_first_ms"].append(
                    cs.device_time(lambda: cr.riccati_scan_cuda_batched(*bf, reg), 20))
                if "stage_cycles" not in row:
                    row["stage_cycles"] = {
                        "batch_last": cr.riccati_stage_clocks(bl, reg),
                        "batch_first": cr.riccati_stage_clocks(bf, reg, cr.BATCH_FIRST)}
        print(json.dumps({f"{n}x{m}_{tag}_B{B}_T{T}": rows}), flush=True)
        del bl, bf, ref
    print(json.dumps({"build_s": build_s, "seconds": time.perf_counter() - t0}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
