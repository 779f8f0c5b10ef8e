"""Offline analysis (port of mageslam_tpu/analysis): volume of interest and
point-cloud denoising.

Replaces VolumeOfInterest/ and Clouds/ from the reference (both operate on
fossilized outputs, not the live pipeline).
"""

from .voi import VoiSettings, calculate_volume_of_interest, make_voi_keyframes  # noqa: F401
from .clouds import (  # noqa: F401
    compute_characteristics,
    compute_normals,
    knn,
    mollify_normals,
    reposition_points,
)
