"""Device layer: camera calibrations, IMU characterizations, presets (port
of mageslam_tpu/device).

Replaces Core/MAGESLAM/Source/Device/ + Plat/: per-device calibration presets
(the calibration constants are device measurements, reproduced as data) and
the IMU noise/extrinsics description consumed by the fuser.
"""

from .presets import (  # noqa: F401
    CameraDevice,
    IMUCharacterization,
    get_camera_device,
    get_imu_characterization,
    SUPPORTED_DEVICES,
)
