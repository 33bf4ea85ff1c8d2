"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` — one
``nvcc`` process per source, all started together (``md_allpairs.cu``,
``md_list.cu``, ``md_sw.cu``, ``md_multi.cu`` and ``md_k5.cu`` share device
code through ``md_kernel.cuh``, ``md_k1.cu`` and ``md_k1m.cu`` through
``md_k1.cuh`` on top of it, ``md_k3.cu``, ``md_k4.cu`` and ``md_k4_big.cu``
through ``md_charged.cuh``, ``md_slim.cu`` and ``md_slim_ring.cu``
through ``md_slim.cuh``; ``pairwise_l2.cu`` and ``sw_bricks.cu`` stand
alone) —
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
non-zero code.  A failed build and a failed launch raise :class:`KernelError`,
which no caller retries: a build error repeats, and a launch error leaves
the CUDA context unusable.
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
    # K2: x, out, n, d, the tile edge (0: the kernel's rule), the stream;
    # its first design: x, out, n, d, the stream
    "pairwise_l2_f32": [_P, _P, _I, _I, _I, _P],
    "pairwise_l2_first_f32": [_P, _P, _I, _I, _P],
    # the first designs of K1, K3 (all-pairs) and K4 (gather list), and K5
    # (SW): a pointer to the MDArgs structure (md_fused._MDArgs) and the stream
    "md_allpairs_run_f32": [_P, _P],
    "md_allpairs_forces_f32": [_P, _P],
    # K1 (md_k1.cu): a pointer to K1Args (md_fused._K1Args) and the stream,
    # for the run and the force entry; and (entry: 0 run, 1 forces; atoms,
    # types, int[4]) -> registers, local bytes, blocks per SM, threads
    "md_k1_run_f32": [_P, _P],
    "md_k1_forces_f32": [_P, _P],
    "md_k1_info": [_I, _I, _I, _P],
    # K1m (md_k1m.cu): the K1Args pointer, jobs per block, the stream; and
    # (jobs, sample, atoms, types, int[4]) as md_k1_info's; K1m's first
    # design (md_multi.cu): the MDArgs pointer, jobs per block, the stream
    "md_k1m_run_f32": [_P, _I, _P],
    "md_k1m_info": [_I, _I, _I, _I, _P],
    "md_allpairs_run_multi_f32": [_P, _I, _P],
    "md_list_run_f32": [_P, _P],
    "md_list_forces_f32": [_P, _P],
    # K3 and K4 (md_k3.cu, md_k4.cu): a pointer to CArgs (md_fused._K34Args)
    # and the stream, for the run and the force entry; (entry, atoms, types,
    # int[4]) -> registers, local bytes, blocks per SM, threads; K4's
    # cluster form (md_k4_big.cu): a pointer to ClArgs (md_fused._K4ClArgs)
    # and the stream, and (atoms, types, rows per CTA, CTAs per job, int[5])
    # -> registers, local bytes, clusters at once, threads, shared bytes per
    # CTA; its global form: CArgs and the stream, and (atoms, types, int[4])
    "md_k3_run_f32": [_P, _P],
    "md_k3_forces_f32": [_P, _P],
    "md_k3_info": [_I, _I, _I, _P],
    "md_k4_run_f32": [_P, _P],
    "md_k4_forces_f32": [_P, _P],
    "md_k4_info": [_I, _I, _I, _P],
    "md_k4_cluster_run_f32": [_P, _P],
    "md_k4_cluster_info": [_I, _I, _I, _I, _P],
    "md_k4_big_run_f32": [_P, _P],
    "md_k4_big_info": [_I, _I, _P],
    # K5 (md_k5.cu): a pointer to K5Args (md_fused._K5Args) and the stream,
    # for the run and the force entry; (entry: 0 run, 1 moments, 2 forces;
    # atoms, list cap, int[4]); its first design (md_sw.cu): MDArgs, stream
    "md_k5_run_f32": [_P, _P],
    "md_k5_forces_f32": [_P, _P],
    "md_k5_info": [_I, _I, _I, _P],
    "md_sw_run_f32": [_P, _P],
    "md_sw_forces_f32": [_P, _P],
    # K6's first design (SW tiles): tiles, [adjoints,] nbr, valid, h, h^-1,
    # out, B, C, K, a pointer to the constants (sw_bricks._SWK) and the stream
    "sw_moments_f32": [_P] * 6 + [_I] * 3 + [_P, _P],
    "sw_forces_f32": [_P] * 7 + [_I] * 3 + [_P, _P],
    # K6 (the path's): tiles, nbr, valid, h, h^-1, spheres, out, count, list,
    # cap, B, C, K, constants, stream; and tiles, adjoints, nbr, valid, h,
    # h^-1, count, list, cap, out, overflow, B, C, K, constants, stream;
    # (kernel, int[4]) -> registers, local bytes, blocks per SM, threads
    "sw_moments_list_f32": [_P] * 9 + [_I] * 4 + [_P, _P],
    "sw_forces_list_f32": [_P] * 8 + [_I] + [_P] * 2 + [_I] * 3 + [_P, _P],
    "sw_kernel_info": [_I, _P],
    # P1's first design (the kernel lab's slim runs): a pointer to SlimArgs
    # (md_slim._SlimArgs), the variant id, the stream
    "md_slim_run_f32": [_P, _I, _P],
    # the variant id, atoms per box, a pointer to the int result
    "md_slim_occupancy": [_I, _I, _P],
    # P1's redesign (md_slim_ring.cu): a pointer to RingArgs
    # (md_slim._RingArgs), the variant id, the stream; and (variant, atoms,
    # depth, int[12]) -> registers, local bytes, blocks per SM, the block
    # (md_slim.ring_info)
    "md_slim_ring_run_f32": [_P, _I, _P],
    "md_slim_ring_info": [_I, _I, _I, _P],
}

class KernelError(RuntimeError):
    """A kernel that did not build or did not launch."""


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
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
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
        raise KernelError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    build_log += link.stdout + link.stderr
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise KernelError(f"nvcc link failed ({link.returncode}):\n{build_log}")
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
        raise KernelError(f"{name}: kernel launch failed with cudaError_t {rc}")
