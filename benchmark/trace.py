"""The profiled stretch as plain records, and the sums the per-layer readers
take from it.

Each record is (name, kind, start_us, end_us): kind 'kernel', 'memcpy' or
'memset' for an operation on the device, 'cpu' for a host range.  A device
kernel is the program's when one of the identifiers in its name is a
``__global__`` function of the port's CUDA sources (``wire_tpu_torch/
csrc``, read at run time, so a kernel a later change adds is the
program's too), cuFFT's when its name holds 'fft', and PyTorch's
otherwise; copies and memsets are PyTorch's.
"""
from __future__ import annotations

import bisect
import glob
import os
import re

from benchmark import lookup

_GLOBAL = re.compile(r"__global__\s+(?:static\s+)?void\s+"
                     r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_WORD = re.compile(r"\w+")
SCAN = 2000


def program_kernels(csrc=None):
    """The names of the ``__global__`` functions of the port's sources."""
    csrc = csrc or os.path.join(lookup.CHECKOUT, "wire_tpu_torch", "csrc")
    names = set()
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu*"))):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    if not names:
        raise RuntimeError(f"no __global__ function found under {csrc}")
    return names


def owner(name, kind, program):
    """'program', 'cufft' or 'torch'."""
    if kind == "kernel":
        if program.intersection(_WORD.findall(name)):
            return "program"
        if "fft" in name.lower():
            return "cufft"
    return "torch"


def records(prof):
    """The profiler's events as records."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            low = e.name.lower()
            kind = ("memcpy" if low.startswith("memcpy") else
                    "memset" if low.startswith("memset") else "kernel")
        else:
            kind = "cpu"
        out.append((e.name, kind, float(start), float(end)))
    return out


class Stretch:
    """Sums over the device records of a profiled stretch of ``epochs``
    epochs."""

    def __init__(self, recs, epochs, window_s, program):
        self.epochs = epochs
        self.window_s = window_s
        self.device = sorted((r for r in recs if r[1] != "cpu"),
                             key=lambda r: r[2])
        self.cpu = sorted((r for r in recs if r[1] == "cpu"),
                          key=lambda r: r[2])
        self._cpu_starts = [r[2] for r in self.cpu]
        self.by_owner = {"program": 0.0, "cufft": 0.0, "torch": 0.0}
        self.kernels = {}
        self.launches = 0
        for name, kind, s, e in self.device:
            self.by_owner[owner(name, kind, program)] += e - s
            self.kernels[name] = self.kernels.get(name, 0.0) + (e - s)
            self.launches += kind == "kernel"
        self.program_launches = sum(
            1 for name, kind, _, _ in self.device
            if owner(name, kind, program) == "program")

    def per_epoch_ms(self, owner_name):
        return self.by_owner[owner_name] / 1e3 / self.epochs

    def busy_us(self):
        """The union of the device records' intervals."""
        busy, last = 0.0, -float("inf")
        for _, _, s, e in self.device:
            if e > last:
                busy += e - max(s, last)
                last = e
        return busy

    def gaps(self):
        """(start, end) of each idle interval between device records."""
        out, last = [], None
        for _, _, s, e in self.device:
            if last is not None and s > last:
                out.append((last, s))
            last = e if last is None else max(last, e)
        return out

    def gap_owner(self, mid):
        """The innermost host range around time ``mid``, or 'none': the
        shortest one that holds it.  Ranges are scanned back from ``mid``
        until one starts too early to be shorter than the best so far, and
        at most ``SCAN`` of them."""
        best = None
        top = bisect.bisect_right(self._cpu_starts, mid) - 1
        for i in range(top, max(top - SCAN, -1), -1):
            name, _, s, e = self.cpu[i]
            if best is not None and mid - s >= best[1]:
                break
            if e >= mid and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "none"

    def breakdown(self, top=10):
        """{device_ops, idle_gaps}: the device operations that took most
        time, and the idle time by what the host was doing, seconds, at most
        ``top`` each."""
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        idle = {}
        for s, e in self.gaps():
            key = self.gap_owner(0.5 * (s + e))
            idle[key] = idle.get(key, 0.0) + (e - s)
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], us / 1e6] for n, us in ops],
                "idle_gaps": [[n[:160], us / 1e6] for n, us in gaps]}
