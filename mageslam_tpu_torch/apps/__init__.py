"""Applications around the session (port of mageslam_tpu/apps): so far the
trajectory evaluation."""
