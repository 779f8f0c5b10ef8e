"""Bag-of-words word assignment and the vocabulary's k-medoid iteration:
the CUDA kernels and their plain PyTorch versions.

Port of the TPU kernel mageslam_tpu/ops/pallas_kernels.py
`hamming_matrix_pallas` together with its bag-of-words consumers,
mageslam_tpu/bow/index.py `assign_words` and one iteration of
mageslam_tpu/bow/vocab.py `train_vocabulary` (`_majority_descriptor`).

- `assign(desc, valid, anchors)`: (R,) int32 word of each (R, 8) descriptor
  against V <= 64 anchors, the first minimum, -1 where invalid.
- `vocab_step(desc, valid, anchors)`: the (V, 8) anchors after one k-medoid
  iteration over the pool: assignment, integer bit votes, majority, an empty
  word keeping its anchor.

CPU tensors take the plain versions (`assign_plain`, `vocab_step_plain`: the
(R, V) matrix from `hamming_matrix_plain`, argmin, one_hot and a float
matmul of votes, exact below 2^24); CUDA tensors launch
`csrc/bow_words.cu`, one launch a call, with no fallback between the two.
`ASSIGN_LAUNCHES` and `STEP_LAUNCHES` count the launches.
"""

from __future__ import annotations

import torch

from . import _build
from .hamming import WORDS, hamming_matrix_plain

BIG = 1 << 20
MAX_WORDS = 64
ASSIGN_LAUNCHES = 0
STEP_LAUNCHES = 0
# the vocab step's scratch: (64, 256) votes, (64,) counts, a ticket
_SCRATCH_INTS = MAX_WORDS * 256 + MAX_WORDS + 1
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def descriptor_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words → (N, 256) float32 0/1 bits, bit b of word w at
    32 w + b (shifted as int64, so the sign bit is bit 31 and no more)."""
    shifts = torch.arange(32, device=desc.device)
    bits = (desc.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 32 * WORDS).to(torch.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(V, 256) 0/1 → (V, 8) int32 words with the same bits (bit 31 the sign)."""
    shifts = torch.arange(32, device=bits.device)
    words = torch.sum(bits.to(torch.int64).reshape(-1, WORDS, 32) << shifts, dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def majority_descriptors(bits: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Bitwise majority over each word's members: bits (N, 256) from
    `descriptor_bits`, member (N, V) bool → (V, 8) int32. A bit is set when
    at least half the members set it (an empty word counts 1 member)."""
    m = member.to(torch.float32)
    votes = m.T @ bits               # (V, 256), exact: counts < 2^24, TF32 off
    count = torch.clamp_min(m.sum(0), 1.0)
    return pack_bits(votes * 2 >= count[:, None])


def assign_plain(desc: torch.Tensor, valid: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """`assign` as tensor code: argmin over the (R, V) distance matrix (the
    first minimum), -1 where invalid."""
    word = torch.argmin(hamming_matrix_plain(desc, anchors), dim=1)
    return torch.where(valid, word.to(torch.int32), -1)


def vocab_step_plain(desc: torch.Tensor, valid: torch.Tensor,
                     anchors: torch.Tensor) -> torch.Tensor:
    """`vocab_step` as tensor code."""
    bits = descriptor_bits(desc)
    d = torch.where(valid[:, None], hamming_matrix_plain(desc, anchors), BIG)
    word = torch.argmin(d, dim=1)                                      # first minimum
    member = torch.nn.functional.one_hot(word, anchors.shape[0]).to(torch.bool) \
        & valid[:, None]
    new_anchors = majority_descriptors(bits, member)
    # empty clusters keep their anchor
    return torch.where(member.any(0)[:, None], new_anchors, anchors).contiguous()


def _check(t: torch.Tensor, name: str, device: torch.device, dtype: torch.dtype,
           shape: tuple[int, ...], fn: str) -> None:
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _launch_args(desc, valid, anchors, fn: str) -> tuple[torch.device, int, int, int]:
    """Checks the kernel's inputs; returns (device, rows, words, stream)."""
    device = desc.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"{fn}: unsupported device {device} (the current CUDA device "
                         f"is the launch's device)")
    n_rows, n_words = desc.shape[0], anchors.shape[0]
    if not 1 <= n_words <= MAX_WORDS:
        raise ValueError(f"{fn}: {n_words} anchors, the kernel takes 1 to {MAX_WORDS}")
    _check(desc, "desc", device, torch.int32, (n_rows, WORDS), fn)
    _check(valid, "valid", device, torch.bool, (n_rows,), fn)
    _check(anchors, "anchors", device, torch.int32, (n_words, WORDS), fn)
    if desc.data_ptr() % 16 or anchors.data_ptr() % 16:   # 16- and 8-byte loads
        raise ValueError(f"{fn}: desc and anchors must be 16-byte aligned")
    return device, n_rows, n_words, torch._C._cuda_getCurrentRawStream(device.index)


def assign(desc: torch.Tensor, valid: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(R,) int32 word of each descriptor desc (R, 8) int32 against anchors
    (V, 8), V <= 64: the first minimum of the Hamming distances, -1 where
    valid (R,) is false."""
    if all(t.device.type == "cpu" for t in (desc, valid, anchors)):
        return assign_plain(desc, valid, anchors)
    global ASSIGN_LAUNCHES
    device, n_rows, n_words, stream = _launch_args(desc, valid, anchors, "bow assign")
    out = torch.empty((n_rows,), dtype=torch.int32, device=device)
    if n_rows == 0:
        return out
    rc = _build.library().mageslam_bow_assign(
        desc.data_ptr(), valid.data_ptr(), anchors.data_ptr(), out.data_ptr(), n_rows,
        n_words, stream)
    if rc != 0:
        raise RuntimeError(f"bow assign kernel launch failed: cudaError {rc}")
    ASSIGN_LAUNCHES += 1
    return out


def _step_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """Zeroed scratch for the vocab step, one a (device, stream): the kernel
    leaves it zero, so it is cleared once, when it is made."""
    key = (device.index, stream)
    if key not in _scratch:
        _scratch[key] = torch.zeros((_SCRATCH_INTS,), dtype=torch.int32, device=device)
    return _scratch[key]


def vocab_step(desc: torch.Tensor, valid: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """The (V, 8) int32 anchors after one k-medoid iteration over the pool
    desc (N, 8), valid (N,): each valid row joins its word (`assign`), each
    word's anchor becomes the bitwise majority of its members (a bit is set
    where at least half of them set it), a word without members keeps its
    anchor."""
    if all(t.device.type == "cpu" for t in (desc, valid, anchors)):
        return vocab_step_plain(desc, valid, anchors)
    global STEP_LAUNCHES
    device, n_rows, n_words, stream = _launch_args(desc, valid, anchors, "bow vocab_step")
    out = torch.empty((n_words, WORDS), dtype=torch.int32, device=device)
    rc = _build.library().mageslam_bow_vocab_step(
        desc.data_ptr(), valid.data_ptr(), anchors.data_ptr(), out.data_ptr(),
        _step_scratch(device, stream).data_ptr(), n_rows, n_words, stream)
    if rc != 0:
        raise RuntimeError(f"bow vocab_step kernel launch failed: cudaError {rc}")
    STEP_LAUNCHES += 1
    return out
