"""Imported first by every tests/test_torch_*.py file, before torch.

torch's OpenMP threads wait passively (they sleep) between parallel
regions instead of spinning. The suite runs several workers on shared
cores beside JAX's own thread pools: a spinning thread there burns a core
the other workers need, and a descheduled one stalls its partner at the
next barrier (a port session ran 1.9x slower at 2 threads than passively
waiting, under the same JAX load). Results do not change: the thread count
each file sets, and so every summation order, stays the same. libgomp reads
the variable once, when torch loads it, so this module comes before torch
and before anything that imports torch.
"""

import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
