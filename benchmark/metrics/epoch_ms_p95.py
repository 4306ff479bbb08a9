"""The 95th percentile of every epoch's time in the window: the interval
between consecutive epoch boundaries (CUDA events), each fit's first epoch
and any idle gap included."""
from benchmark import window


def read(run):
    return window.p95([ms for f in run.fits for ms in f["intervals_ms"]])
