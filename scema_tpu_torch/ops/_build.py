"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` — one
``nvcc`` process per source, all started together (``md_allpairs.cu``,
``md_list.cu``, ``md_sw.cu`` and ``md_multi.cu`` share their device code through
``md_kernel.cuh``; ``pairwise_l2.cu`` and ``sw_bricks.cu`` stand alone) —
and the objects are
linked into ONE shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, writes into
``build/scema_tpu_torch/`` at the repository root, and is keyed by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads the cached library.  Nothing here runs
when a module is imported: the CPU tests import every module on machines
without ``nvcc``.

Each exported C function launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "scema_tpu_torch"
# -Xptxas -v reports registers, shared memory and spills per kernel into
# build_log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# exported symbol -> argtypes (pointers and the stream as c_void_p so they
# are passed as 64-bit values)
SIGNATURES = {
    "pairwise_l2_f32": [_P, _P, _I, _I, _P],
    # K1/K3 (all-pairs), K4 (gather list) and K5 (SW): a pointer to the
    # MDArgs structure (md_fused._MDArgs) and the stream
    "md_allpairs_run_f32": [_P, _P],
    "md_allpairs_forces_f32": [_P, _P],
    # K1m: the MDArgs pointer, jobs per block, the stream
    "md_allpairs_run_multi_f32": [_P, _I, _P],
    "md_list_run_f32": [_P, _P],
    "md_list_forces_f32": [_P, _P],
    "md_sw_run_f32": [_P, _P],
    "md_sw_forces_f32": [_P, _P],
    # K6 (SW tiles): tiles, [adjoints,] nbr, valid, h, h^-1, out, B, C, K,
    # a pointer to the constants (sw_bricks._SWK) and the stream
    "sw_moments_f32": [_P] * 6 + [_I] * 3 + [_P, _P],
    "sw_forces_f32": [_P] * 7 + [_I] * 3 + [_P, _P],
}

_lib = None
build_seconds = None  # wall time of the last nvcc build (None: cache hit)
build_log = ""  # nvcc's output of the last build


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # sources and their shared headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libscema_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library exists; returns its path.
    The compiler's output is kept in :data:`build_log`."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        build_seconds = None
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [src.name for src, p in zip(sources(), procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    build_log += link.stdout + link.stderr
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{build_log}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")
