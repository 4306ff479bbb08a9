"""The port's kernels against their roofline: the sum over an epoch's
kernel calls of each call's least time (the larger of its operations at
the engine's peak and its bytes at the HBM bandwidth, from the frozen
counts) over the device time an epoch of every kernel that is neither
PyTorch's nor cuFFT's, in the profiled stretch.  Keyed to the work, not to
kernel names."""
from benchmark import peaks


def read(run):
    s = run.stretch
    if s is None or s.by_owner["program"] == 0:
        return None
    least = sum(peaks.least_s(flops, nbytes, engine)[0]
                for _, flops, nbytes, engine in run.work)
    return 100.0 * least * 1e3 / s.per_epoch_ms("program")
