"""Frontend and matching ops; `hamming` holds the CUDA kernel's wrapper."""
