"""Build and load the package's CUDA kernels and its native host library at
first use.

`csrc/*.cu` hold kernels with a plain C interface. Each source is compiled
with nvcc for Hopper (`sm_90a`) by its own process, all started together,
and the objects are linked into one shared library in
`hairsplitter_tpu_torch/build/` (git-ignored), loaded with ctypes. No
PyTorch headers are compiled, so a build takes seconds. The library name
carries a hash of the sources, so an edited kernel is never served from a
stale build. `csrc/hs_native.cpp`, the host-runtime library (seeding, pins,
POA, token decoding), is built the same way with g++ (`build_native`).

Every kernel launch goes through `launch`, which counts it by kernel in the
table that `kernel_launch_counts` returns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = (
    "myers_rows.cu", "myers_fused.cu", "banded_dp.cu", "banded_fused.cu", "window_stats.cu", "chain_seeds.cu",
)
HEADERS = ("host_emulation.cuh", "myers_common.cuh", "banded_common.cuh")  # included by the sources: part of the digest
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

NATIVE_SOURCE = "hs_native.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

# hs_chain_seeds' arguments before its stream, as hs_chain_seeds_host (the
# host build of the same source) takes them
CHAIN_SEEDS_ARGTYPES = [
    ctypes.c_void_p,  # codes int8
    ctypes.c_void_p,  # read offsets int64 [n + 1]
    ctypes.c_void_p,  # original read lengths int32 [n]
    ctypes.c_void_p,  # original offset of each compressed base int32 (or null)
    ctypes.c_void_p,  # allowed contig int32 [n] (or null)
    ctypes.c_int,  # n
    ctypes.c_void_p,  # index hashes uint64
    ctypes.c_void_p,  # index positions int32
    ctypes.c_void_p,  # index contig ids int32
    ctypes.c_void_p,  # index strands int8
    ctypes.c_int64,  # index entries
    ctypes.c_int,  # k
    ctypes.c_int,  # w
    ctypes.c_int,  # max_occ
    ctypes.c_int,  # min_anchors
    ctypes.c_double,  # min_score_frac
    ctypes.c_double,  # max_overlap_frac
    ctypes.c_void_p,  # scratch
    ctypes.c_int64,  # hit capacity
    ctypes.c_int64,  # chain capacity
    ctypes.c_void_p,  # packed result
]

_lib = None
build_info: dict = {}  # seconds, library path and ptxas report of the last build/load
# this process's launches so far, by kernel (`hs_<kernel>` in the library)
_launches = dict.fromkeys(
    ("myers_fused", "myers_rows", "banded_fused", "banded_dp", "window_stats", "chain_seeds"), 0
)


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
    for name in SOURCES + HEADERS:
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
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"{os.path.splitext(s)[0]}.o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        reports = [proc.communicate()[1].strip() for proc in procs]  # waits for every compile
        for src, proc, err in zip(SOURCES, procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{err}")
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    build_info.update(
        path=so, seconds=time.perf_counter() - t0, cached=False, ptxas="\n".join(reports)
    )
    return so


def build_native() -> str:
    """Compile the native host library with g++ (unless an up-to-date build
    exists); returns the shared library's path. Raises RuntimeError when the
    compiler is missing or fails."""
    src = os.path.join(CSRC_DIR, NATIVE_SOURCE)
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libhs_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    gxx = shutil.which(os.environ.get("CXX", "g++"))
    if gxx is None:
        raise RuntimeError("g++ not found: the native host library needs a C++17 compiler")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, "lib.so")
        try:
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, src], capture_output=True, text=True, timeout=300)
        except subprocess.TimeoutExpired as exc:
            raise RuntimeError(f"g++ timed out on {NATIVE_SOURCE}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {NATIVE_SOURCE} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    build_info.update(native_path=so, native_seconds=time.perf_counter() - t0)
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
        lib.hs_myers_fused.restype = ctypes.c_int
        lib.hs_myers_fused.argtypes = [
            ctypes.c_void_p,  # q int8 [N, B]
            ctypes.c_void_p,  # t int8 [N, T]
            ctypes.c_void_p,  # q_lens int32 [N]
            ctypes.c_void_p,  # t_lens int32 [N]
            ctypes.c_void_p,  # modes int32 [N]
            ctypes.c_int,  # N
            ctypes.c_int,  # B
            ctypes.c_int,  # T
            ctypes.c_void_p,  # scratch: (nonleft, isup) words [B, N, 2, 4]
            ctypes.c_void_p,  # out uint8 [N, 16 + B]
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.hs_myers_fused_occupancy.restype = ctypes.c_int
        lib.hs_myers_fused_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]  # B, T
        lib.hs_banded_dp.restype = ctypes.c_int
        lib.hs_banded_dp.argtypes = [
            ctypes.c_void_p,  # q int8 [N, B]
            ctypes.c_void_p,  # t int8 [N, T]
            ctypes.c_void_p,  # q_lens int32 [N]
            ctypes.c_void_p,  # t_lens int32 [N]
            ctypes.c_int,  # N
            ctypes.c_int,  # B
            ctypes.c_int,  # T
            ctypes.c_int,  # emit_enc
            ctypes.c_void_p,  # plane: uint8 bp or int16 enc [N, B, W]
            ctypes.c_void_p,  # row_at_q int32 [N, W]
            ctypes.c_void_p,  # colmin_val int32 [N]
            ctypes.c_void_p,  # colmin_i int32 [N]
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.hs_banded_fused.restype = ctypes.c_int
        lib.hs_banded_fused.argtypes = [
            ctypes.c_void_p,  # q int8 [N, B]
            ctypes.c_void_p,  # t int8 [N, T]
            ctypes.c_void_p,  # q_lens int32 [N]
            ctypes.c_void_p,  # t_lens int32 [N]
            ctypes.c_void_p,  # modes int32 [N]
            ctypes.c_int,  # N
            ctypes.c_int,  # B
            ctypes.c_int,  # T
            ctypes.c_void_p,  # out uint8 [N, 16 + B]
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.hs_banded_fused_smem_bytes.restype = ctypes.c_int
        lib.hs_banded_fused_smem_bytes.argtypes = [ctypes.c_int]  # B
        lib.hs_banded_fused_occupancy.restype = ctypes.c_int
        lib.hs_banded_fused_occupancy.argtypes = [ctypes.c_int]  # B
        lib.hs_window_stats.restype = ctypes.c_int
        lib.hs_window_stats.argtypes = [
            ctypes.c_void_p,  # flat int8 [sum of rows, P]
            ctypes.c_void_p,  # offsets int64 [nb + 1]
            ctypes.c_void_p,  # codes int8 [nb, P]
            ctypes.c_int,  # nb
            ctypes.c_int,  # P
            ctypes.c_void_p,  # top codes int32 [nb, P, 3]
            ctypes.c_void_p,  # top counts int32 [nb, P, 3]
            ctypes.c_void_p,  # coverage int32 [nb, P]
            ctypes.c_void_p,  # mismatched cells int64 [nb]
            ctypes.c_void_p,  # covered cells int64 [nb]
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.hs_chain_seeds.restype = ctypes.c_int
        lib.hs_chain_seeds.argtypes = CHAIN_SEEDS_ARGTYPES + [ctypes.c_void_p]  # cudaStream_t
        _lib = lib
    return _lib


def launch(kernel: str, device, *args) -> None:
    """One launch of `hs_<kernel>` on `device`'s current stream: `args` are
    its arguments before the stream. Raises RuntimeError when the launch
    returns a CUDA error; counts the launch in `kernel_launch_counts()`."""
    fn = getattr(load_kernels(), f"hs_{kernel}")
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hs_{kernel} launch failed with CUDA error {rc}")
    _launches[kernel] += 1


def kernel_launch_counts() -> dict[str, int]:
    """This process's CUDA kernel launches so far, by kernel."""
    return dict(_launches)
