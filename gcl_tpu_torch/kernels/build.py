"""Build and load the CUDA kernel library (nvcc -> shared library -> ctypes).

Every ``*.cu`` under ``gcl_tpu_torch/csrc`` is compiled for ``sm_90a`` (one
nvcc per source, all started together) and linked into one shared library
with a plain C interface, at first use, into ``build/kernels/`` beside the
package. The file name carries a hash of the
sources, their ``*.cuh`` headers and the flags, so an edited source builds
anew and an unchanged one is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argtypes (pointers and the stream as void*, ints as int,
# a count of queries as long long)
SIGNATURES = {
    "sparse_conv_implicit_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "occupancy_conv_fwd": [_P] * 5 + [_I] * 4 + [_P],
    "sparse_conv_implicit_bwd": [_P] * 8 + [_I] * 6 + [_P],
    "occupancy_conv_dw": [_P] * 3 + [_I] * 3 + [_P],
    "scalar_conv_fwd": [_P] * 7 + [_I] * 4 + [_P],
    "scalar_conv_dw": [_P] * 7 + [_I] * 4 + [_P],
    "scalar_conv_dx": [_P] * 7 + [_I] * 4 + [_P],
    "windowed_cell_topk": [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P],
    "join_kmap": [_P] * 6 + [_I, _L, _P],
    "sparse_conv_table_fwd": [_P] * 4 + [_I] * 5 + [_P],
    "sparse_conv_implicit_dw": [_P] * 6 + [_I] * 5 + [_P],
    "sparse_conv_table_dw": [_P] * 4 + [_I] * 5 + [_P],
    "sparse_conv_fwd_count_rows": [_P],
    "sparse_conv_bwd_count_rows": [_P],
    "sparse_conv_bwd_count_dw_rows": [_P],
    "sparse_conv_dw_count_rows": [_P],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cand.append(found)
    for path in cand:
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgcl_kernels_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """The kernel library, compiled on first call (raises on failure)."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for src, obj in zip(_sources(), objs)]
            logs = [proc.communicate() for proc in procs]
            for src, proc, (out, err) in zip(_sources(), procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src.name} "
                                       f"({proc.returncode}):\n{out}\n{err}")
            lib_tmp = os.path.join(tmp, "lib.so")
            link = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                                   f"{link.stdout}\n{link.stderr}")
            os.replace(lib_tmp, path)
        build_info.update(seconds=time.perf_counter() - t0,
                          ptxas="\n".join(err.strip() for _, err in logs),
                          path=str(path))
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
