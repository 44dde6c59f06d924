"""Build and load the package's CUDA kernels (plain C interface + ctypes).

``load()`` compiles ``icp_tpu_torch/csrc/nn_kernel.cu`` with nvcc into
``icp_tpu_torch/build/`` at first use and loads it with ctypes. The library
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "nn_kernel.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib = None
# what the last build printed (ptxas register/shared-memory report) and
# how long it took; None when the library was already built
build_log: str | None = None
build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libicp_nn_{h.hexdigest()[:12]}.so"


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    path = _library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
        build_seconds = time.perf_counter() - t0
        build_log = (proc.stdout + proc.stderr).strip()
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.icp_nn.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp]
    lib.icp_nn.restype = ci
    lib.icp_nn_min.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp, vp]
    lib.icp_nn_min.restype = ci
    _lib = lib
    return lib
