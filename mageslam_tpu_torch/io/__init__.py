"""Host I/O (port of mageslam_tpu/io): so far the sensor sample logs."""

from .sensor_log import SensorLogReader, SensorLogWriter  # noqa: F401
