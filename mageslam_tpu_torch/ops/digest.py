"""The stream path's state digest: a 24-bit integer hash of the map after a
frame, carried as the chunk summary's last column to the Determinator
(port of mageslam_tpu/runtime/pipeline.py:1187-1217).

The words of `mp_pos` (P, 3) and then `kf_pose.t` (K, 3), float32 read as
uint32 bits, are position-mixed and XOR-folded; the counts of valid points
and keyframes and frames_since_keyframe are mixed in; the result is cut to
24 bits so that a float32 column carries it exactly. Integer arithmetic, so
a replay gives the same digest whatever order the device sums in.

CPU tensors take the plain version (`state_digest_plain`: int64 tensor
code masked to 32 bits after every product, and an XOR fold by halving);
CUDA tensors launch `csrc/state_digest.cu`, one launch a call (one
thread-block cluster merging in distributed shared memory: nothing is kept
between calls), with no fallback between the two; a refused launch raises.
`LAUNCHES` counts the launches.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 of int64 tensors holding values below 2^32, through
    16-bit halves of b so that no int64 product overflows."""
    b_lo, b_hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & _M32


def state_digest_plain(mp_pos: torch.Tensor, kf_t: torch.Tensor, mp_valid: torch.Tensor,
                       kf_valid: torch.Tensor, fsk: torch.Tensor) -> torch.Tensor:
    """`state_digest` as tensor code."""
    dev = mp_pos.device
    words = torch.cat([mp_pos.reshape(-1), kf_t.reshape(-1)])
    bits = words.view(torch.int32).to(torch.int64) & _M32
    idx = torch.arange(bits.numel(), dtype=torch.int64, device=dev)
    mult = (2654435761 + _mul32(idx, 2246822519)) & _M32
    h = _mul32(bits ^ (bits >> 16), mult)
    while h.numel() > 1:                      # XOR fold by halving
        if h.numel() % 2:
            h = torch.cat([h, h.new_zeros(1)])
        h = h[: h.numel() // 2] ^ h[h.numel() // 2:]
    h = h.reshape(-1)[:1] if h.numel() else torch.zeros(1, dtype=torch.int64, device=dev)
    n_points = torch.sum(mp_valid.to(torch.int64)).reshape(1)
    n_kf = torch.sum(kf_valid.to(torch.int64)).reshape(1)
    h = h ^ _mul32(n_points, 2654435769)
    h = h ^ _mul32(fsk.to(torch.int64).reshape(1) & _M32, 40503)
    h = h ^ _mul32(n_kf, 668265263)
    return ((h ^ (h >> 8)) & 0xFFFFFF).to(torch.float32)


def _check(t: torch.Tensor, name: str, device: torch.device, dtype: torch.dtype,
           shape: tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"state_digest: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"state_digest: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"state_digest: {name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"state_digest: {name} must be contiguous")


def check_cuda(mp_pos: torch.Tensor, kf_t: torch.Tensor, mp_valid: torch.Tensor,
               kf_valid: torch.Tensor, fsk: torch.Tensor) -> torch.device:
    """The kernel's argument checks on CUDA tensors; returns the launch's
    device."""
    device = mp_pos.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"state_digest: unsupported device {device} (the current CUDA "
                         f"device is the launch's device)")
    P, K = mp_pos.shape[0], kf_t.shape[0]
    _check(mp_pos, "mp_pos", device, torch.float32, (P, 3))
    _check(kf_t, "kf_t", device, torch.float32, (K, 3))
    _check(mp_valid, "mp_valid", device, torch.bool, (P,))
    _check(kf_valid, "kf_valid", device, torch.bool, (K,))
    _check(fsk, "fsk", device, torch.int32, tuple(fsk.shape))
    if fsk.numel() != 1:
        raise ValueError(f"state_digest: fsk must hold one value, got {fsk.numel()}")
    return device


def launch(tensors, out: torch.Tensor) -> None:
    """One launch of the kernel on checked CUDA `tensors` (mp_pos, kf_t,
    mp_valid, kf_valid, fsk) into `out` (1,), on the current stream;
    counted in LAUNCHES."""
    mp_pos, kf_t = tensors[0], tensors[1]
    rc = _build.library().mageslam_state_digest(
        *(t.data_ptr() for t in tensors), out.data_ptr(), mp_pos.shape[0], kf_t.shape[0],
        torch._C._cuda_getCurrentRawStream(mp_pos.device.index))
    if rc != 0:
        raise RuntimeError(f"state_digest kernel launch failed: cudaError {rc}")
    _build.count_launch(globals(), "LAUNCHES")


def state_digest(mp_pos: torch.Tensor, kf_t: torch.Tensor, mp_valid: torch.Tensor,
                 kf_valid: torch.Tensor, fsk: torch.Tensor) -> torch.Tensor:
    """(1,) float32 digest of the map: mp_pos (P, 3) float32, kf_t (K, 3)
    float32 (the keyframes' translations), mp_valid (P,) and kf_valid (K,)
    bool, fsk a one-element int32 tensor (frames since the last keyframe)."""
    tensors = (mp_pos, kf_t, mp_valid, kf_valid, fsk)
    if all(t.device.type == "cpu" for t in tensors):
        return state_digest_plain(*tensors)
    out = torch.empty((1,), dtype=torch.float32, device=check_cuda(*tensors))
    launch(tensors, out)
    return out
