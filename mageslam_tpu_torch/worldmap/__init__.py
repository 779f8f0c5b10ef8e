"""Map state (the parts tracking reads)."""
