"""Per-device calibration presets (Device/SupportedDevices.cpp:16-122; the
port's own copy of mageslam_tpu/device/presets.py).

The numeric constants are measured device calibrations (data, not code):
Surface Pro 3 / Surface Book fixed-focus pinhole models and the Lumia 950's
focus-dependent LinearFocalLengthModel + IMU characterization. They are
consumed through `geometry.camera.LinearFocalLengthModel` exactly like the
reference consumes `calibration::LinearFocalLengthModel`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..geometry.camera import LinearFocalLengthModel

_G = 9.80665


@dataclass(frozen=True)
class IMUCharacterization:
    """Device/IMUCharacterization equivalent (SupportedDevices.cpp:98-160)."""

    use_magnetometer: bool = False
    apply_sensitivity_estimation: bool = False
    default_initial_bias_variance_factor: float = 1.0
    accel_sample_rate_ms: float = 4.0
    gyro_sample_rate_ms: float = 4.0
    mag_sample_rate_ms: float = 16.0
    accel_noise_sigma: float = 0.0
    gyro_noise_sigma: float = 0.0
    accel_bias_sigma: float = 0.0
    gyro_bias_sigma: float = 0.0
    body_camera_to_body_imu: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclass(frozen=True)
class CameraDevice:
    name: str
    model: LinearFocalLengthModel
    default_focus: float = 0.0


def _surface_pro3() -> CameraDevice:
    return CameraDevice(
        name="SurfacePro3",
        model=LinearFocalLengthModel(
            fx_m=0.0, fx_b=1845.75 / 1920.0,
            fy_m=0.0, fy_b=1840.4 / 1080.0,
            cx=979.76 / 1920.0, cy=573.47 / 1080.0,
            calibration_width=1920, calibration_height=1080,
            distortion=(0.0, 0.0, 0.0, 0.0, 0.0),
        ),
    )


def _surface_book() -> CameraDevice:
    return CameraDevice(
        name="SurfaceBook",
        model=LinearFocalLengthModel(
            fx_m=0.0, fx_b=1587.29 / 1920.0,
            fy_m=0.0, fy_b=1585.59 / 1080.0,
            cx=963.24 / 1920.0, cy=560.54 / 1080.0,
            calibration_width=1920, calibration_height=1080,
            distortion=(0.0, 0.0, 0.0, 0.0, 0.0),
        ),
    )


def _lumia_950() -> CameraDevice:
    return CameraDevice(
        name="Lumia950",
        model=LinearFocalLengthModel(
            fx_m=-0.0001100515625, fx_b=0.81877777291667,
            fy_m=-0.0001882685185, fy_b=1.45169039537037,
            cx=0.506385416667, cy=0.51153703703704,
            focal_bound_lo=550.0, focal_bound_hi=700.0,
            calibration_width=1920, calibration_height=1080,
            distortion=(0.094227405, -0.350755726, 0.416357188, 0.0, 0.0),
        ),
        default_focus=650.0,
    )


def _lumia_950_imu() -> IMUCharacterization:
    accel_rate, gyro_rate = 4.0, 4.0
    body_camera_to_body_imu = np.array([
        [-0.0023918196093291044, -0.99980247020721436, 0.019730480387806892, 0.02890799380838871],
        [-0.99998271465301514, 0.0024972527753561735, 0.0053207604214549065, 0.10563744604587555],
        [-0.0053689810447394848, -0.019717413932085037, -0.99979120492935181, 0.0064810086041688919],
        [0.0, 0.0, 0.0, 1.0],
    ], np.float32)
    return IMUCharacterization(
        accel_sample_rate_ms=accel_rate,
        gyro_sample_rate_ms=gyro_rate,
        # micro-g/√Hz and millideg/s/√Hz converted at half-bandwidth
        accel_noise_sigma=250.0e-6 * _G * math.sqrt(0.5 / (1e-3 * accel_rate)),
        gyro_noise_sigma=math.radians(20.0e-3) * math.sqrt(0.5 / (1e-3 * gyro_rate)),
        body_camera_to_body_imu=body_camera_to_body_imu,
    )


SUPPORTED_DEVICES = {
    "SurfacePro3": _surface_pro3,
    "SurfaceBook": _surface_book,
    "Lumia950": _lumia_950,
}


def get_camera_device(name: str) -> CameraDevice:
    try:
        return SUPPORTED_DEVICES[name]()
    except KeyError:
        raise ValueError(
            f"unknown device {name!r}; supported: {sorted(SUPPORTED_DEVICES)}")


def get_imu_characterization(name: str) -> IMUCharacterization:
    if name == "Lumia950":
        return _lumia_950_imu()
    return IMUCharacterization()
