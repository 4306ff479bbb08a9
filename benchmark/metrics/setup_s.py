"""Set-up: process start to the first timed fit (imports, the CUDA context,
the kernel libraries, the warm-up fit at the cell's shapes)."""


def read(run):
    return run.setup_s
