"""Build and load the package's CUDA kernels at first use.

`csrc/*.cu` hold kernels with a plain C interface; they are compiled with
nvcc for Hopper (`sm_90a`) into `hairsplitter_tpu_torch/build/` (git-ignored)
and loaded with ctypes. No PyTorch headers are compiled, so a build takes
seconds. The library name carries a hash of the sources, so an edited
kernel is never served from a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("myers_rows.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_info: dict = {}  # seconds, library path and ptxas report of the last build/load


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(force: bool = False) -> str:
    """Compile the kernels (unless an up-to-date build exists); returns the
    shared library's path and records the build time in `build_info`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libhs_kernels_{_sources_digest()}.so")
    if os.path.exists(so) and not force:
        if build_info.get("path") != so:  # keep the record of a build made here
            build_info.update(path=so, seconds=0.0, cached=True)
        return so
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    build_info.update(
        path=so, seconds=time.perf_counter() - t0, cached=False, ptxas=proc.stderr.strip()
    )
    return so


def load_kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.hs_myers_rows.restype = ctypes.c_int
        lib.hs_myers_rows.argtypes = [
            ctypes.c_void_p,  # qT int8 [B, N]
            ctypes.c_void_p,  # tT int8 [T, N]
            ctypes.c_int,  # N
            ctypes.c_int,  # B
            ctypes.c_int,  # T
            ctypes.c_void_p,  # P words
            ctypes.c_void_p,  # M words
            ctypes.c_void_p,  # nonleft words (or null)
            ctypes.c_void_p,  # isup words (or null)
            ctypes.c_void_p,  # cudaStream_t
        ]
        _lib = lib
    return _lib
