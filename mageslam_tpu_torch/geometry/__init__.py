from .se3 import Pose  # noqa: F401
