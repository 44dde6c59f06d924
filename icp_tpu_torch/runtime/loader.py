"""ctypes binding to the native lidar CSV parser (csrc/fastcsv.cpp;
counterpart of icp_tpu.runtime.loader).

``get_lib()`` compiles ``icp_tpu_torch/csrc/fastcsv.cpp`` into
``icp_tpu_torch/build/`` at first use and loads it with ctypes (plain C
ABI, no pybind11). The library's name carries a hash of the source and the
command's flags, so an edited source is rebuilt and a stale library is
never loaded; the build writes to a temporary name and renames. Nothing is
built at import.

A machine with no C++ compiler gets ``None`` from ``get_lib()`` and
``services.lidar`` then parses with numpy. Nothing else falls back: a
compiler that is found and fails raises with its output, and a library
that was built and does not load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fastcsv.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
# nvcc compiles plain C++ through its host compiler; -fPIC goes to that
NVCC_FLAGS = ["-O3", "-Xcompiler", "-fPIC", "-shared", "-std=c++17"]

_lib = None


def find_compiler():
    """(path, flags) of the first C++ compiler found among ``$CXX``, g++,
    c++ and, last, nvcc; None on a machine with none."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = shutil.which(name) if name else None
        if found:
            return found, CXX_FLAGS
    found = shutil.which("nvcc")
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if not found and root and os.path.exists(
                os.path.join(root, "bin", "nvcc")):
            found = os.path.join(root, "bin", "nvcc")
    return (found, NVCC_FLAGS) if found else None


def _library_path(flags) -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"libfastcsv_{h.hexdigest()[:12]}.so"


def get_lib():
    """Build (if needed) and load the native library; cached per process.
    None when the machine has no C++ compiler."""
    global _lib
    if _lib is not None:
        return _lib
    compiler = find_compiler()
    if compiler is None:
        return None
    cxx, flags = compiler
    path = _library_path(flags)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))        # OSError if it does not load
    lib.lidar_parse.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_void_p)]
    lib.lidar_parse.restype = ctypes.c_int
    lib.lidar_num_scans.argtypes = [ctypes.c_void_p]
    lib.lidar_num_scans.restype = ctypes.c_int64
    lib.lidar_num_points.argtypes = [ctypes.c_void_p]
    lib.lidar_num_points.restype = ctypes.c_int64
    for name in ("lidar_timestamps", "lidar_offsets"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.POINTER(ctypes.c_int64)
    lib.lidar_points.argtypes = [ctypes.c_void_p]
    lib.lidar_points.restype = ctypes.POINTER(ctypes.c_float)
    lib.lidar_free.argtypes = [ctypes.c_void_p]
    lib.lidar_free.restype = None
    _lib = lib
    return lib


def load_lidar_csv(path: str):
    """Parse a whole lidar CSV natively.

    Returns a list of (timestamp_raw, (N, 3) float32 points), padding
    triples already dropped. Raises RuntimeError when the machine has no
    C++ compiler (``services.lidar`` asks ``get_lib()`` first).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastcsv unavailable: no C++ compiler "
                           "($CXX, g++, c++, nvcc) was found")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    handle = ctypes.c_void_p()
    rc = lib.lidar_parse(os.fsencode(path), ctypes.byref(handle))
    if rc != 0:
        raise RuntimeError(f"lidar_parse({path}) failed rc={rc}")
    try:
        n = lib.lidar_num_scans(handle)
        npts = lib.lidar_num_points(handle)
        ts = np.ctypeslib.as_array(lib.lidar_timestamps(handle),
                                   shape=(n,)).copy() if n else np.zeros(0, np.int64)
        offs = np.ctypeslib.as_array(lib.lidar_offsets(handle),
                                     shape=(n + 1,)).copy()
        pts = (np.ctypeslib.as_array(lib.lidar_points(handle),
                                     shape=(npts, 3)).copy()
               if npts else np.zeros((0, 3), np.float32))
    finally:
        lib.lidar_free(handle)
    return [(int(ts[i]), pts[offs[i]:offs[i + 1]]) for i in range(n)]
