"""Bundle adjustment (pose-only LM, the tracking hot path)."""
