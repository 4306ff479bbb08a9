"""Tracing and throughput (port of wire_tpu/train/profiling.py): a
``torch.profiler`` trace with CPU and CUDA activities, a coords/s counter
and a fit run under an optional trace."""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block with torch.profiler (CPU, and CUDA where there is
    a card) and write a TensorBoard trace under ``log_dir``; yields the
    profiler, whose ``key_averages()`` the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class Throughput:
    """coords/s counter: feed points-processed increments, read the rate."""

    def __init__(self):
        self.t0 = time.time()
        self.points = 0

    def add(self, npoints):
        self.points += int(npoints)

    @property
    def coords_per_s(self):
        dt = time.time() - self.t0
        return self.points / dt if dt > 0 else float("nan")


def profile_fit(fit_fn, *args, log_dir=None, **kwargs):
    """Run a fit under an optional trace: (result, coords/s), the rate from
    the fit's epochs times the rows of its coordinates (the third
    positional argument) over its wall time."""
    ctx = trace(log_dir) if log_dir else contextlib.nullcontext()
    with ctx:
        res = fit_fn(*args, **kwargs)
    coords = args[2].shape[0] if len(args) > 2 else None
    cps = None
    if coords is not None and res.wall_time_s > 0:
        cps = len(res.mse_gt) * coords / res.wall_time_s
    return res, cps
