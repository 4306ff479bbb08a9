"""The device's idle share: 1 - the profiled stretch's device busy time an
epoch (the union of its operations) over the mean unprofiled epoch time of
the same process.  The profiled wall time is never the denominator: the
profiler's own host cost would count as idle."""


def read(run):
    s = run.stretch
    if s is None or not run.unprofiled_ms:
        return None
    busy_ms = s.busy_us() / 1e3 / s.epochs
    return 100.0 * (1.0 - busy_ms / run.unprofiled_ms)
