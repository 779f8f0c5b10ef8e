"""Host I/O (port of mageslam_tpu/io): the `.mgts` capture format and its
native prefetching loader, the sensor sample logs and the session's on-disk
snapshot, each in the reference's format."""

from .capture import CaptureHeader, CaptureReader, CaptureWriter  # noqa: F401
from .sensor_log import SensorLogReader, SensorLogWriter  # noqa: F401
from .snapshot import load_session_snapshot, save_session_snapshot  # noqa: F401
