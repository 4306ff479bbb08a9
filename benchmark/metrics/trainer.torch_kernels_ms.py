"""Device time an epoch of PyTorch's own operations (Adam, best tracking,
the fold, stacking, copies; not cuFFT, not the port's kernels) in the
profiled stretch."""


def read(run):
    if run.stretch is None:
        return None
    return run.stretch.per_epoch_ms("torch")
