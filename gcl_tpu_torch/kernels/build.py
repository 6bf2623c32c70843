"""Build and load the CUDA kernel library (nvcc -> shared library -> ctypes).

Every ``*.cu`` under ``gcl_tpu_torch/csrc`` is compiled for ``sm_90a`` (one
nvcc per source, all started together) and linked into one shared library
with a plain C interface, at first use, into ``build/kernels/`` beside the
package. The file name carries a hash of the
sources, their ``*.cuh`` headers and the flags, so an edited source builds
anew and an unchanged one is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes (pointers and the stream as void*, ints as int)
SIGNATURES = {
    "sparse_conv_implicit_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "occupancy_conv_fwd": [_P] * 5 + [_I] * 5 + [_P],
    "sparse_conv_implicit_bwd": [_P] * 8 + [_I] * 6 + [_P],
    "occupancy_conv_dw": [_P] * 3 + [_I] * 3 + [_P],
    "scalar_conv_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "scalar_conv_dw": [_P] * 7 + [_I] * 5 + [_P],
    "scalar_conv_dx": [_P] * 7 + [_I] * 4 + [_P],
    "windowed_cell_topk": [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P],
    "join_kmap": [_P] * 6 + [_I] * 6 + [_P],
    "sparse_conv_table_fwd": [_P] * 4 + [_I] * 5 + [_P],
    "sparse_conv_implicit_dw": [_P] * 6 + [_I] * 5 + [_P],
    "sparse_conv_table_dw": [_P] * 4 + [_I] * 5 + [_P],
    "ransac_score": [_P] * 6 + [_I] * 2 + [ctypes.c_float, _P],
    "sparse_conv_fwd_count_rows": [_P],
    "sparse_conv_bwd_count_rows": [_P],
    "sparse_conv_bwd_count_dw_rows": [_P],
    "sparse_conv_dw_count_rows": [_P],
    "join_kmap_count_keys": [_P],
    "occupancy_conv_fwd_count_keys": [_P],
    "scalar_conv_count_keys": [_P],
    "windowed_cell_topk_count_keys": [_P],
}

# the bf16 forms of the conv kernels take their float32 forms' arguments
BF16_FORMS = ("sparse_conv_implicit_fwd", "sparse_conv_table_fwd",
              "sparse_conv_implicit_bwd", "sparse_conv_implicit_dw",
              "sparse_conv_table_dw", "occupancy_conv_fwd",
              "occupancy_conv_dw", "scalar_conv_fwd", "scalar_conv_dw",
              "scalar_conv_dx")
SIGNATURES.update({f"{name}_bf16": SIGNATURES[name] for name in BF16_FORMS})

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


# the features' types the conv kernels take: float32, and bf16 (products
# and sums in float32, outputs rounded to bf16 once; weight gradients
# float32)
FEATURE_DTYPES = (torch.float32, torch.bfloat16)


def check_features(name: str, t: torch.Tensor) -> None:
    """Raise unless t is of a feature type the conv kernels take."""
    if t.dtype not in FEATURE_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def summing(t: torch.Tensor) -> torch.Tensor:
    """t in the type that the plain versions multiply and sum in: float32
    for float32 and bf16 (a product of two bf16 is exact in float32),
    float64 for float64 (the plain versions take it; the kernels do not)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def tiled(v: torch.Tensor, tile: int, fill: int) -> torch.Tensor:
    """[..., N] -> [..., ceil(N / tile), tile], the ragged tail filled."""
    pad = -v.shape[-1] % tile
    if pad:
        v = torch.cat([v, v.new_full((*v.shape[:-1], pad), fill)], -1)
    return v.reshape(*v.shape[:-1], -1, tile)


def entry(name: str, dtype: torch.dtype):
    """The C entry point ``name`` in the form for features of ``dtype``."""
    return getattr(load_library(),
                   name if dtype == torch.float32 else f"{name}_bf16")


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


@contextlib.contextmanager
def counted(device, setters, size: int, what: str):
    """While the block runs, the launches of the sources whose C counter
    setters (entry point names) are ``setters`` add what they count on
    ``device`` into an int64 tensor [size] on the card, which this yields
    and which holds the sums once the block has ended. For checks: one
    atomic add per block, and launches outside the block count nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the kernels count on a CUDA device, not {device}")
    lib = load_library()
    counter = torch.zeros(size, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        for name in setters:
            check(getattr(lib, name)(counter.data_ptr()), what)
        try:
            yield counter
        finally:
            torch.cuda.synchronize()
            for name in setters:
                check(getattr(lib, name)(None), what)
