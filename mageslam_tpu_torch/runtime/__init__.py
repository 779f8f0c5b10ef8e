"""Runtime: the per-frame session (port of mageslam_tpu/runtime), split by
concern: `track_step` (tracking), `post_step` (bookkeeping), `session`
(the host state machine)."""

from .pose_history import PoseHistory  # noqa: F401
from .session import FrameResult, SlamSession, TrackingState  # noqa: F401
