"""Build the port's CUDA kernels at first use and load them with ctypes.

Every `.cu` file under `mageslam_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`), one `nvcc` a file, all started together, and the objects
are linked into one shared library with a plain C interface, under
`mageslam_tpu_torch/_build/`; the `.cuh` headers there (`hamming_tile.cuh`,
the tensor-core distance tile of `hamming.cu`, `two_way_match.cu` and
`bow_words.cu`, whose word loads `local_best.cu` shares; `cluster.cuh`, the
thread-block-cluster merge of `local_best.cu` and `state_digest.cu`) are
included by them. The library's name
carries a hash of the sources, headers and flags, so an edited file
rebuilds and an unchanged tree loads the existing library. A missing `nvcc`
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")
# The session's mapping offload launches kernels from a worker thread beside
# the main one: the wrappers' launch counts and their per-(device, stream)
# scratch caches are updated under these locks.
COUNT_LOCK = threading.Lock()
CACHE_LOCK = threading.Lock()


def count_launch(namespace: dict, name: str) -> None:
    """Add one to a wrapper's launch count `namespace[name]` (its module's
    globals) under COUNT_LOCK: `+=` on a global is no atomic update."""
    with COUNT_LOCK:
        namespace[name] += 1


def sources() -> list[str]:
    """The `.cu` and `.cuh` files the library is built from."""
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
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
    tmp = f"{path}.{os.getpid()}.tmp"
    objs_dir = f"{tmp}.objs"
    os.makedirs(objs_dir, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    units = [s for s in sources() if s.endswith(".cu")]
    objs = [os.path.join(objs_dir, os.path.basename(u) + ".o") for u in units]
    compiles = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", o, u], text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for u, o in zip(units, objs)]
    logs = [c.communicate()[0] for c in compiles]
    failed = [(u, c.returncode, log) for u, c, log in zip(units, compiles, logs)
              if c.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs], text=True,
                              capture_output=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode, logs[-1]))
    shutil.rmtree(objs_dir, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(
            f"{os.path.basename(u)} ({rc}):\n{log}" for u, rc, log in failed))
    os.replace(tmp, path)   # atomic: a concurrent build sees old or new
    return path, time.perf_counter() - t0, "".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build()[0])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        # a, b, out, n, m, stream
        "mageslam_hamming_matrix": [ptr] * 3 + [i32] * 2 + [ptr],
        # q_desc, q_octave, q_valid, q_xy, radius, t_desc, t_xy, t_octave,
        # t_valid, out_idx, out_dist, zeroed, claims, n_stages, n_query,
        # n_target, octave_tol, max_hamming, min_diff, group, stream
        "mageslam_radius_match": [ptr] * 13 + [i32] * 7 + [ptr],
        # desc_a, valid_a, desc_b, valid_b, scratch, out_idx, out_dist,
        # a_stride, n_batch, n_a, n_b, max_hamming, min_diff, stream
        "mageslam_two_way_match": [ptr] * 7 + [i64] + [i32] * 5 + [ptr],
        # desc, valid, anchors, out, n_rows, n_words, stream
        "mageslam_bow_assign": [ptr] * 4 + [i32] * 2 + [ptr],
        # desc, valid, anchors, out, scratch, n_rows, n_words, stream
        "mageslam_bow_vocab_step": [ptr] * 5 + [i32] * 2 + [ptr],
        # mp_pos, kf_t, mp_valid, kf_valid, fsk, out, n_points, n_keyframes,
        # stream
        "mageslam_state_digest": [ptr] * 6 + [i32] * 2 + [ptr],
        # q_desc, q_xy, q_valid, t_desc, t_xy, t_valid, best, best_q, second,
        # radius, max_hamming, n_query, n_target, stream
        "mageslam_local_best": [ptr] * 9 + [ctypes.c_float] + [i32] * 3 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
