"""Settings shared with the JAX package, without importing it.

`mageslam_tpu/config.py` imports only the standard library, but
`import mageslam_tpu.config` runs `mageslam_tpu/__init__.py`, which imports
jax. So the file is loaded here by path, as a module of its own, and its
settings classes are re-exported unchanged.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_NAME = "mageslam_tpu_torch._jax_config"
_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "mageslam_tpu", "config.py")


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _PATH)
    module = importlib.util.module_from_spec(spec)
    # dataclasses resolve string annotations through sys.modules
    sys.modules[_NAME] = module
    spec.loader.exec_module(module)
    return module


_config = _load()

MageSlamSettings = _config.MageSlamSettings
golden_path_settings = _config.golden_path_settings
