"""mageslam_tpu_torch — the PyTorch/CUDA port of mageslam_tpu.

Same sub-package layout and function names as `mageslam_tpu` (the JAX
reference), written as plain PyTorch functions on tensors. Hand-written
kernels live in `csrc/` and are built with `nvcc` at first use
(`ops/_build.py`); each has a plain PyTorch version beside it that serves
CPU tensors only.

This package never imports jax. Settings come from the JAX package's
`config.py`, loaded by path (`_config.py`); JAX state crosses over through
the JAX package's on-disk snapshot format (`interop.py`).
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM geometry is precision-critical, and rBRIEF bits compare blurred
# values: keep every float32 matmul and convolution in full float32 on the
# card (TF32 keeps ~3 decimal digits). Mirrors the forced f32 matmul
# precision of mageslam_tpu/__init__.py:15-20.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from ._config import MageSlamSettings, golden_path_settings  # noqa: E402,F401
from .runtime import FrameResult, SlamSession, TrackingState  # noqa: E402,F401
