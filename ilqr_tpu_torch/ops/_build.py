"""Builds the package's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` launchers
that take raw device pointers and a stream), so it compiles in seconds with
``nvcc`` alone — no PyTorch headers, no ninja:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -shared -Xcompiler -fPIC -o build/ilqr_tpu_torch/lib<name>_<hash>.so \
         csrc/<name>.cu

:func:`build` starts one ``nvcc`` per library, all together, and waits for
them.  Each source also has a stage-clock build, ``<name>_clocks``: the same
file with ``-DRICCATI_STAGE_CLOCKS`` (``clock64()`` counters per stage of a
step, see the sources), loaded only by ``cuda_riccati.riccati_stage_clocks``
and never on the main path.

A library named ``<source>_<n>x<m>_<f32|f64>`` (see :func:`instance`) is one
instantiation of the kernel at any ``(n, m)``: the source compiled with
``-DRICCATI_N=<n> -DRICCATI_M=<m> -DRICCATI_SCALAR=<float|double>``, which
exports one generic launcher, ``riccati_cuda_instance``, in place of the
source's fixed instantiations.  It is built at first use like the others,
and has its stage-clock build too (``..._clocks``).
``csrc/riccati_large.cu``, ``csrc/riccati_xl.cu`` and
``csrc/riccati_cluster.cu`` have no fixed instantiation: they are built
only this way.

The library's name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  The build directory
is ``build/ilqr_tpu_torch/`` beside the package (git-ignored), or
``$ILQR_TPU_TORCH_BUILD_DIR``.  A failed build raises with the compiler's
output; nothing falls back.

Nothing here runs when the module is imported: a machine with no ``nvcc``
imports the package and never calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
# One shared library per source with fixed instantiations.
SOURCES = ("riccati", "riccati_wide")
# Every source an instantiation library may be built from.
INSTANCE_SOURCES = SOURCES + ("riccati_large", "riccati_xl",
                               "riccati_cluster")
# The stage-clock builds: library -> (source, extra nvcc flags).
VARIANTS = {f"{name}_clocks": (name, ("-DRICCATI_STAGE_CLOCKS",))
            for name in SOURCES}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# An instantiation library: <source>_<n>x<m>_<f32|f64>[_clocks].
_INSTANCE = re.compile(r"^(%s)_(\d+)x(\d+)_(f32|f64)(_clocks)?$"
                       % "|".join(INSTANCE_SOURCES))
_SCALARS = {"f32": "float", "f64": "double"}


def instance(source: str, n: int, m: int, tag: str) -> str:
    """The library name of ``source`` instantiated at ``(n, m)`` in
    ``tag`` (``"f32"`` or ``"f64"``)."""

    name = f"{source}_{n}x{m}_{tag}"
    if not _INSTANCE.match(name):
        raise ValueError(
            f"no instantiation {name!r} of csrc/{INSTANCE_SOURCES}")
    return name


def _source_and_flags(name: str):
    if name in VARIANTS or name in SOURCES:
        source, extra = VARIANTS.get(name, (name, ()))
        return CSRC / f"{source}.cu", NVCC_FLAGS + extra
    match = _INSTANCE.match(name)
    if match is None:
        raise ValueError(f"unknown library {name!r}: csrc/ has {SOURCES}, "
                         "their stage-clock builds and the instantiations "
                         f"<source>_<n>x<m>_<f32|f64> of {INSTANCE_SOURCES}")
    source, n, m, tag, clocks = match.groups()
    extra = (f"-DRICCATI_N={n}", f"-DRICCATI_M={m}",
             f"-DRICCATI_SCALAR={_SCALARS[tag]}")
    if clocks:
        extra += ("-DRICCATI_STAGE_CLOCKS",)
    return CSRC / f"{source}.cu", NVCC_FLAGS + extra

_loaded: Dict[str, ctypes.CDLL] = {}
# Seconds of the nvcc run that built each library in this process.
build_seconds: Dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("ILQR_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "ilqr_tpu_torch"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels of ilqr_tpu_torch are built "
        "from source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src, flags = _source_and_flags(name)
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """Where the compiler's output of the last build of ``name`` is kept
    (``-Xptxas -v``: registers, spills and shared memory per kernel)."""

    return library_path(name).with_suffix(".log")


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns ``(process, tmp, out)`` or
    ``None`` when the library is already built."""

    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    src, flags = _source_and_flags(name)
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    output, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{output}")
    log_path(name).write_text(output)
    os.replace(tmp, out)  # atomic: a concurrent process loads a whole file


def build(names: Iterable[str] = SOURCES) -> None:
    """Build every named library that is not built yet, one ``nvcc`` per
    library, all started together."""

    started = [(n, _start_build(n)) for n in names if n not in _loaded]
    for n, s in started:
        _finish_build(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a source of ``csrc/``, one of
    :data:`VARIANTS` or an :func:`instance`), built first if needed."""

    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
