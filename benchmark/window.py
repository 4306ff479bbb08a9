"""The window's arithmetic: each fit's seed, when to start another fit, the
epoch intervals and their tail."""
from __future__ import annotations

import hashlib
import statistics


def fit_seed(seed, k):
    """The seed of fit ``k`` of a run at ``seed`` (k = -1: the warm-up), a
    whole number under 2**31: numpy's RandomState and the apps take it."""
    digest = hashlib.sha256(f"{int(seed)}/{int(k)}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def start_another(elapsed_s, nfits, seconds):
    """Whether a run that has finished ``nfits`` fits in ``elapsed_s``
    starts one more: only while the mean fit so far predicts that it ends
    inside ``seconds``.  The first fit always starts."""
    if nfits == 0:
        return True
    return elapsed_s + elapsed_s / nfits <= seconds


def intervals(marks_ms):
    """Consecutive differences of one fit's epoch boundaries (ms, the last
    one the fit's end): one interval an epoch."""
    return [b - a for a, b in zip(marks_ms[:-1], marks_ms[1:])]


def p95(values):
    """The 95th percentile, as ``statistics.quantiles(values, n=20)``
    (the 'exclusive' method) gives it."""
    if len(values) < 2:
        raise ValueError("a 95th percentile needs two values or more")
    return statistics.quantiles(values, n=20)[18]


def unprofiled(fits, stretch):
    """Every epoch interval (ms) but each fit's first and those at or next
    to the profiled stretch (fit index, first epoch, count; None when the
    run was not traced)."""
    out = []
    for i, fit in enumerate(fits):
        for e, ms in enumerate(fit["intervals_ms"]):
            if e == 0:
                continue
            if stretch is not None and i == stretch[0] and \
                    stretch[1] - 1 <= e <= stretch[1] + stretch[2]:
                continue
            out.append(ms)
    return out
