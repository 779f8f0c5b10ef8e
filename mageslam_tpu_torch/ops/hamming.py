"""All-pairs Hamming distance: the CUDA kernel and its plain PyTorch version.

Port of the TPU kernel mageslam_tpu/ops/pallas_kernels.py
`hamming_matrix_pallas`. Descriptors are (·, 8) int32 tensors holding the
bits of the reference's uint32 words (torch's uint32 lacks `>>` and `-` on
the CPU); the kernel reads them as uint32.

`hamming_matrix(a, b)` takes the plain version for CPU tensors and launches
`csrc/hamming.cu` for CUDA tensors; there is no fallback between the two.
`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

WORDS = 8
LAUNCHES = 0


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (all 32 bits, sign bit
    included). SWAR on the zero-extended int64 value, so no shift drags the
    sign bit in and no step overflows."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def hamming_matrix_plain(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, M) int32 distances: XOR, popcount, sum over the 8 words."""
    out = torch.zeros((desc_a.shape[0], desc_b.shape[0]), dtype=torch.int32,
                      device=desc_a.device)
    for k in range(WORDS):
        out += popcount32(desc_a[:, k, None] ^ desc_b[None, :, k])
    return out


def _check(desc: torch.Tensor, name: str, device: torch.device) -> None:
    if desc.device != device:
        raise ValueError(f"{name} is on {desc.device}, expected {device}")
    if desc.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 descriptor words, got {desc.dtype}")
    if desc.dim() != 2 or desc.shape[1] != WORDS:
        raise ValueError(f"{name} must be (rows, {WORDS}), got {tuple(desc.shape)}")
    if not desc.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, M) int32 Hamming distances between (N, 8) and (M, 8) int32
    descriptor banks."""
    if desc_a.device.type == "cpu" and desc_b.device.type == "cpu":
        return hamming_matrix_plain(desc_a, desc_b)
    global LAUNCHES
    device = desc_a.device
    if device.type != "cuda":
        raise ValueError(f"hamming_matrix: unsupported device {device}")
    _check(desc_a, "desc_a", device)
    _check(desc_b, "desc_b", device)
    n, m = desc_a.shape[0], desc_b.shape[0]
    if device.index != torch.cuda.current_device():   # the launch's device
        raise ValueError(f"hamming_matrix: tensors on {device}, current device "
                         f"cuda:{torch.cuda.current_device()}")
    if (n + 31) // 32 > 65535:   # grid rows are 32 A rows each (gridDim.y)
        raise ValueError(f"hamming_matrix: {n} rows exceed the launch grid")
    out = torch.empty((n, m), dtype=torch.int32, device=device)
    if n == 0 or m == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _build.library().mageslam_hamming_matrix(
        desc_a.data_ptr(), desc_b.data_ptr(), out.data_ptr(), n, m, stream)
    if rc != 0:
        raise RuntimeError(f"hamming kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
