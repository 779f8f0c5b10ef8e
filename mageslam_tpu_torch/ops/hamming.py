"""All-pairs Hamming distance: the CUDA kernel and its plain PyTorch version.

Port of the TPU kernel mageslam_tpu/ops/pallas_kernels.py
`hamming_matrix_pallas`. Descriptors are (·, 8) int32 tensors holding the
bits of the reference's uint32 words (torch's uint32 lacks `>>` and `-` on
the CPU); the kernel reads them as uint32.

`hamming_matrix(a, b)` takes the plain version for CPU tensors and launches
`csrc/hamming.cu` for CUDA tensors; there is no fallback between the two.
`LAUNCHES` counts kernel launches. The kernel takes its distances from the
int8 tensor cores as 256 - 2 * (the ±1 bit product); `pm_bits` gives those
±1 bits in the kernel's K order, for its library yardstick `torch._int_mm`.
"""

from __future__ import annotations

import torch

from . import _build

WORDS = 8
LAUNCHES = 0


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (all 32 bits, sign bit
    included). SWAR in int32 on the low 31 bits, whose value is never
    negative, so no shift drags the sign bit in and no step overflows; the
    sign bit is counted apart."""
    sign = (v < 0).to(torch.int32)
    v = v & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    return ((v + (v >> 16)) & 0x3F) + sign


def hamming_matrix_plain(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, M) int32 distances: XOR, popcount, sum over the 8 words. The
    popcount is `popcount32`'s, its per-byte counts (at most 8 a word)
    summed over the words before the bytes are added up once."""
    shape = (desc_a.shape[0], desc_b.shape[0])
    acc = torch.zeros(shape, dtype=torch.int32, device=desc_a.device)
    sign = torch.zeros(shape, dtype=torch.int32, device=desc_a.device)
    for k in range(WORDS):
        v = desc_a[:, k, None] ^ desc_b[None, :, k]
        sign += v < 0
        v = v & 0x7FFFFFFF
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        acc += (v + (v >> 4)) & 0x0F0F0F0F          # bytes <= 64 after 8 words
    v = (acc & 0x00FF00FF) + ((acc >> 8) & 0x00FF00FF)
    return (v & 0xFFFF) + (v >> 16) + sign


def tile_bit_order() -> torch.Tensor:
    """(256,) int64: the bit (32 * word + bit of the word) at each position k
    of the tensor-core tile's K order (csrc/hamming_tile.cuh): k-step s =
    k // 32, mma column c = k % 32, lane t = (c % 16) // 4, byte i = c % 4;
    word 2t + (c >= 16), bit 8i + s."""
    k = torch.arange(256)
    s, c = k // 32, k % 32
    word = 2 * ((c % 16) // 4) + (c >= 16).to(torch.int64)
    return 32 * word + 8 * (c % 4) + s


def pm_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 256) int8 of (..., 8) int32 descriptor words: +1 for a set bit,
    -1 for a clear one, in the tile's K order. The dot product of two rows is
    256 - 2 * Hamming, so `torch._int_mm(pm_bits(a), pm_bits(b).t())` is the
    kernel's product."""
    shifts = torch.arange(32, device=desc.device)
    bits = (desc.to(torch.int64)[..., None] >> shifts) & 1      # sign bits stay above 31
    flat = bits.reshape(*desc.shape[:-1], 32 * WORDS)
    return (flat[..., tile_bit_order().to(desc.device)] * 2 - 1).to(torch.int8)


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
    device = desc_a.device
    if device.type != "cuda":
        raise ValueError(f"hamming_matrix: unsupported device {device}")
    _check(desc_a, "desc_a", device)
    _check(desc_b, "desc_b", device)
    if (desc_a.data_ptr() | desc_b.data_ptr()) & 15:   # staged with 16-byte cp.async
        raise ValueError("hamming_matrix: descriptors must be 16-byte aligned")
    n, m = desc_a.shape[0], desc_b.shape[0]
    if device.index != torch.cuda.current_device():   # the launch's device
        raise ValueError(f"hamming_matrix: tensors on {device}, current device "
                         f"cuda:{torch.cuda.current_device()}")
    if (n + 63) // 64 > 65535:   # grid rows are 64 A rows each (gridDim.y)
        raise ValueError(f"hamming_matrix: {n} rows exceed the launch grid")
    out = desc_a.new_empty((n, m))   # int32 on the launch's device
    if n == 0 or m == 0:
        return out
    rc = _build.library().mageslam_hamming_matrix(
        desc_a.data_ptr(), desc_b.data_ptr(), out.data_ptr(), n, m,
        torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"hamming kernel launch failed: cudaError {rc}")
    _build.count_launch(globals(), "LAUNCHES")
    return out
