"""The sharded guided matcher's per-shard step: the CUDA kernel and its plain
PyTorch version.

Port of the TPU kernel mageslam_tpu/ops/pallas_kernels.py
`hamming_matrix_pallas` together with the work that consumed its (P, N)
output in mageslam_tpu/parallel/sharded_matching.py `_local_best`: for each
of N targets (a frame's feature slots), over P queries (this shard's map
points), the gated Hamming distance's column minimum `best`, the first row
reaching it `best_q` and the minimum over the other rows `second`. A pair is
gated out (distance BIG) unless both are valid, the query lies inside the
target's Chebyshev box of half-width `radius` (float32) and the distance is
at most `max_hamming`.

CPU tensors take `local_best_plain` (the (P, N) matrix from
`hamming_matrix_plain`, the gate, argmin, min); CUDA tensors launch
`csrc/local_best.cu` once a call (a thread-block cluster for each 16
targets, merging in distributed shared memory: nothing is kept between
calls), with no fallback between the two; a refused launch raises.
`LAUNCHES` counts the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .hamming import WORDS, hamming_matrix_plain

BIG = 1 << 20
LAUNCHES = 0
_INVALID_VALUE = 1          # cudaErrorInvalidValue: the entry point refused its sizes


def local_best_plain(q_desc, q_xy, q_valid, t_desc, t_xy, t_valid, radius, max_hamming: int):
    """`local_best` as tensor code: (best, best_q, second), each (N,) int32."""
    if q_desc.shape[0] == 0:
        raise ValueError("local_best: no query rows")
    return local_best_from_distances(hamming_matrix_plain(q_desc, t_desc), q_xy, q_valid,
                                     t_xy, t_valid, radius, max_hamming)


def local_best_from_distances(d, q_xy, q_valid, t_xy, t_valid, radius, max_hamming: int):
    """The gate and the per-column best, argmin and second on a (P, N)
    int32 distance matrix `d` (the TPU path's epilogue)."""
    r = torch.tensor(np.float32(radius), device=q_xy.device)
    dx = torch.abs(q_xy[:, None, 0] - t_xy[None, :, 0])
    dy = torch.abs(q_xy[:, None, 1] - t_xy[None, :, 1])
    ok = (dx <= r) & (dy <= r) & q_valid[:, None] & t_valid[None, :]
    d = torch.where(ok & (d <= max_hamming), d, BIG)
    best_q = torch.argmin(d, dim=0)                       # the first minimum
    best = torch.gather(d, 0, best_q[None])[0]
    second = torch.min(d.scatter(0, best_q[None], BIG), dim=0).values
    return best, best_q.to(torch.int32), second


def _check(t: torch.Tensor, name: str, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"local_best: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"local_best: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"local_best: {name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"local_best: {name} must be contiguous")


def check_cuda(q_desc, q_xy, q_valid, t_desc, t_xy, t_valid) -> torch.device:
    """The kernel's argument checks on CUDA tensors; returns the launch's
    device."""
    device = q_desc.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"local_best: unsupported device {device} (the current CUDA "
                         f"device is the launch's device)")
    P, N = q_desc.shape[0], t_desc.shape[0]
    if P == 0:
        raise ValueError("local_best: no query rows")
    for t, name, dtype, shape in ((q_desc, "q_desc", torch.int32, (P, WORDS)),
                                  (q_xy, "q_xy", torch.float32, (P, 2)),
                                  (q_valid, "q_valid", torch.bool, (P,)),
                                  (t_desc, "t_desc", torch.int32, (N, WORDS)),
                                  (t_xy, "t_xy", torch.float32, (N, 2)),
                                  (t_valid, "t_valid", torch.bool, (N,))):
        _check(t, name, device, dtype, shape)
    if (q_desc.data_ptr() | t_desc.data_ptr() | q_xy.data_ptr() | t_xy.data_ptr()) & 7:
        raise ValueError("local_best: descriptors and positions must be 8-byte aligned")
    return device


def launch(tensors, out: torch.Tensor, radius, max_hamming: int) -> None:
    """One launch of the kernel on checked CUDA `tensors` (q_desc, q_xy,
    q_valid, t_desc, t_xy, t_valid) into `out` (3, N), on the current
    stream; counted in LAUNCHES."""
    q_desc, t_desc = tensors[0], tensors[3]
    P, N = q_desc.shape[0], t_desc.shape[0]
    rc = _build.library().mageslam_local_best(
        *(t.data_ptr() for t in tensors), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), float(np.float32(radius)), int(max_hamming), P, N,
        torch._C._cuda_getCurrentRawStream(q_desc.device.index))
    if rc == _INVALID_VALUE:
        raise ValueError(f"local_best: the kernel refused {P} query rows x {N} targets "
                         f"(its keys hold a row in 22 bits)")
    if rc != 0:
        raise RuntimeError(f"local_best kernel launch failed: cudaError {rc}")
    _build.count_launch(globals(), "LAUNCHES")


def local_best(q_desc, q_xy, q_valid, t_desc, t_xy, t_valid, radius, max_hamming: int):
    """Per target, over the queries: (best (N,), best_q (N,), second (N,))
    int32. q_desc (P, 8) / t_desc (N, 8) int32 descriptor words, q_xy (P, 2)
    / t_xy (N, 2) float32, q_valid (P,) / t_valid (N,) bool, P >= 1."""
    tensors = (q_desc, q_xy, q_valid, t_desc, t_xy, t_valid)
    if all(t.device.type == "cpu" for t in tensors):
        return local_best_plain(*tensors, radius, max_hamming)
    device = check_cuda(*tensors)
    out = torch.empty((3, t_desc.shape[0]), dtype=torch.int32, device=device)
    if t_desc.shape[0]:
        launch(tensors, out, radius, max_hamming)
    return out[0], out[1], out[2]
