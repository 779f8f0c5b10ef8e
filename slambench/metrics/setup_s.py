"""Process start to the first timed frame: imports, CUDA init, loading (and
on a checkout's first run building) the kernels, rendering and uploading
the frame bank, the warm-up frames, the snapshot and the warm pass."""


def read(ctx):
    return ctx["setup_s"]
