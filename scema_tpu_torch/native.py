"""ctypes bindings for the native C++ runtime (native/scema_native.cpp).

A copy of ``scema_tpu/native.py`` for the port.  The library is built at
first use from ``native/scema_native.cpp`` with the host C++ compiler
(``$CXX``, else ``g++``) and the flags of ``native/Makefile``, into
``build/scema_tpu_torch/`` at the repository root, keyed by a hash of the
source and flags; it never loads ``native/libscema_native.so`` (the JAX
package's own build).  Nothing is built when the module is imported.  A
missing compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "scema_native.cpp"
BUILD_DIR = _ROOT / "build" / "scema_tpu_torch"
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]  # native/Makefile's

_LIB = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (set CXX or put g++ on PATH) to build "
                           f"the native runtime from {SOURCE}")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libscema_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the hashed one exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded native library (built on first use)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    lib.msh_parse.restype = ctypes.c_void_p
    lib.msh_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.msh_get.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.msh_free.argtypes = [ctypes.c_void_p]
    lib.reduce_graph.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.write_vtu_binary.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def read_msh_native(path: str):
    """Native gmsh parser; returns (nodes, cells), or None where the file
    does not parse."""
    lib = get_lib()
    nn = ctypes.c_int64()
    nc = ctypes.c_int64()
    handle = lib.msh_parse(path.encode(), ctypes.byref(nn), ctypes.byref(nc))
    if not handle:
        return None
    nodes = np.empty((nn.value, 3), dtype=np.float64)
    cells = np.empty((nc.value, 8), dtype=np.int32)
    lib.msh_get(
        handle,
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    lib.msh_free(handle)
    return nodes, cells


def reduce_graph_native(adj: np.ndarray):
    """Native greedy reduction; returns the mapping."""
    lib = get_lib()
    n = adj.shape[0]
    adj8 = np.ascontiguousarray(adj.astype(np.uint8))
    mapping = np.empty(n, dtype=np.int32)
    lib.reduce_graph(
        n,
        adj8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mapping.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return mapping


def write_vtu_native(path, nodes, cells, point_data=None, cell_data=None):
    """Native binary-appended .vtu writer; returns whether the file was
    written (False where it could not be opened)."""
    lib = get_lib()
    nodes = np.ascontiguousarray(np.asarray(nodes, dtype=np.float64))
    cells = np.ascontiguousarray(np.asarray(cells, dtype=np.int32))

    def prep(data, n_expected):
        names, ncomps, ptrs, keep = [], [], [], []
        for name, arr in (data or {}).items():
            arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
            if arr.ndim == 1:
                arr = arr[:, None]
            assert arr.shape[0] == n_expected
            keep.append(arr)
            names.append(name.encode())
            ncomps.append(arr.shape[1])
            ptrs.append(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        n = len(names)
        return (
            n,
            (ctypes.c_char_p * n)(*names),
            np.asarray(ncomps, dtype=np.int32),
            (ctypes.POINTER(ctypes.c_double) * n)(*ptrs),
            keep,
        )

    npf, pnames, pncomp, pptrs, keep1 = prep(point_data, len(nodes))
    ncf, cnames, cncomp, cptrs, keep2 = prep(cell_data, len(cells))
    ret = lib.write_vtu_binary(
        path.encode(),
        len(nodes),
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(cells),
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        npf,
        pnames,
        pncomp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pptrs,
        ncf,
        cnames,
        cncomp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cptrs,
    )
    return ret == 0
