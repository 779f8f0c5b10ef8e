"""Visual-inertial fusion (port of mageslam_tpu/fuser).

The reference's architecture (Fuser.h:34-75, FuserWorker.cpp:37-80) is a
sorted multi-sensor sample queue with image fences, 3DoF/6DoF Kalman
filters, and a mode state machine WaitForMageInit → WaitForGravityConverge
→ ScaleInit → Tracking driven by tracking events; its filter internals were
never open-sourced. As in the JAX package:
  - `sample_queue` — time-sorted multi-sensor queue with image fences (numpy)
  - `filters` — functional error-state EKF (quaternion attitude, position,
    velocity, gyro/accel biases) with IMU propagation and visual pose
    updates; a 3DoF attitude-only variant for gravity convergence
  - `covariance` — the visual pose covariance from reprojection Jacobians
  - `fuser` — the mode state machine, gravity + metric-scale estimation,
    and pose priors for the tracker (IMUPosePriorProvider equivalent)
"""

from .sample_queue import SensorSample, SampleQueue, SampleType  # noqa: F401
from .filters import EkfState, ekf_init, ekf_predict, ekf_update_pose  # noqa: F401
from .fuser import Fuser, FuserMode  # noqa: F401
