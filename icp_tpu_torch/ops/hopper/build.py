"""Build and load the package's CUDA kernels (plain C interface + ctypes).

Each source under ``icp_tpu_torch/csrc/`` is its own library:
``nn_kernel.cu`` (``icp_nn``, ``icp_nn_min``) and ``segment_add.cu``
(``icp_segment_add``, and ``icp_segment_add_empty``, an empty kernel at
its grid, for timing). ``load(name)`` compiles one with nvcc into
``icp_tpu_torch/build/`` at first use and loads it with ctypes;
``load_all()`` starts one nvcc a missing library, all at once, and loads
every library. A library's name carries a hash of its source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built at import.
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
SOURCES = {"nn": _PKG / "csrc" / "nn_kernel.cu",
           "segment_add": _PKG / "csrc" / "segment_add.cu"}
SOURCE = SOURCES["nn"]
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_libs: dict[str, ctypes.CDLL] = {}
# what each library's last build printed (ptxas register/shared-memory
# report), and the wall time of the last build (None when every library
# was already built)
build_log: dict[str, str] = {}
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


def _library_path(name: str = "nn") -> Path:
    h = hashlib.sha1(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libicp_{name}_{h.hexdigest()[:12]}.so"


def _build(names) -> None:
    """Compile the named libraries that are missing, one nvcc each, all
    started together; raise if any fails (after every nvcc has ended)."""
    global build_seconds
    jobs = []
    t0 = time.perf_counter()
    for name in names:
        path = _library_path(name)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name].name} "
                          f"({proc.returncode}):\n{out}\n{err}")
            continue
        os.replace(tmp, path)
        build_log[name] = (out + err).strip()
    if failed:
        raise RuntimeError("\n".join(failed))
    if jobs:
        build_seconds = time.perf_counter() - t0


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "nn":
        lib.icp_nn.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp]
        lib.icp_nn.restype = ci
        lib.icp_nn_min.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp, vp]
        lib.icp_nn_min.restype = ci
    else:
        lib.icp_segment_add.argtypes = [vp, vp, vp, vp, cll, ci, cll, ci, ci,
                                        vp]
        lib.icp_segment_add.restype = ci
        lib.icp_segment_add_empty.argtypes = [cll, ci, vp]
        lib.icp_segment_add_empty.restype = ci


def load(name: str = "nn") -> ctypes.CDLL:
    """Build (if needed) and load one kernel library; cached per process."""
    if name not in _libs:
        _build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _bind(name, lib)
        _libs[name] = lib
    return _libs[name]


def load_all() -> dict[str, ctypes.CDLL]:
    """Build every missing library in parallel, then load them all."""
    _build([n for n in SOURCES if n not in _libs])
    return {name: load(name) for name in SOURCES}
