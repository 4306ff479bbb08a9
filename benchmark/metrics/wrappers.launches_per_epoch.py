"""Kernel launches an epoch in the profiled stretch, each counted by its
kernel's record on the device (a library linked with the static CUDA
runtime may not show its launch calls to the profiler)."""


def read(run):
    if run.stretch is None:
        return None
    return run.stretch.launches / run.stretch.epochs
