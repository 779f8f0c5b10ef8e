"""Applications around the session (port of mageslam_tpu/apps): the
trajectory evaluation, the photoreal scene renderer and the
visual-inertial evaluation."""
