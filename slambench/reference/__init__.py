"""The plain reference: NumPy and eager PyTorch only, importing nothing of
the program, of JAX or of the JAX package."""
