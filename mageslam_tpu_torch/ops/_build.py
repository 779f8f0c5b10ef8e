"""Build the port's CUDA kernels at first use and load them with ctypes.

Every `.cu` file under `mageslam_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into one shared library with a plain C interface, under
`mageslam_tpu_torch/_build/`. The library's name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing file. A missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmageslam_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float, str]:
    """Build the library if it is missing. Returns (path, seconds spent
    building, compiler output); an up-to-date library costs 0 seconds."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}"
                           f"\n{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent build sees old or new
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build()[0])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        # a, b, out, n, m, stream
        "mageslam_hamming_matrix": [ptr] * 3 + [i32] * 2 + [ptr],
        # q_desc, q_octave, q_valid, q_xy, radius, t_desc, t_xy, t_octave,
        # t_valid, out_idx, out_dist, n_stages, n_query, n_target,
        # octave_tol, max_hamming, min_diff, stream
        "mageslam_radius_match": [ptr] * 11 + [i32] * 6 + [ptr],
        # desc_a, valid_a, desc_b, valid_b, scratch, out_idx, out_dist,
        # a_stride, n_batch, n_a, n_b, max_hamming, min_diff, stream
        "mageslam_two_way_match": [ptr] * 7 + [i64] + [i32] * 5 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
