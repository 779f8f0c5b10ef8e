"""Per-frame tracking: motion prior, guided matching, track-local-map,
keyframe decision."""
