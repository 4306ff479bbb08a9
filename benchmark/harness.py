"""One cell's run: set-up, the window of whole fits, the output check,
the metrics.  ``run.py`` drives it on the card; the tests drive it on the
CPU at a small size, with faults planted underneath."""
from __future__ import annotations

import gc
import time
import types

import torch

from benchmark import check, lookup, trace, window
from benchmark.probe import Probe
from benchmark.reference.matmul import PRECISIONS

# where a traced run profiles: the first fit, from this epoch, this many
STRETCH_FROM, STRETCH_EPOCHS = 200, 200


class CellRun:
    def __init__(self, spec, cell_name, device, overrides=None):
        """``overrides``: {"config": {...}, "traffic": {...}} merged into the
        cell's files (the tests' small sizes; never set on the card)."""
        self.spec = spec
        self.cell = lookup.cell(spec, cell_name)
        self.config = dict(lookup.config(self.cell["config"]))
        self.traffic = dict(lookup.traffic(self.cell["traffic"]))
        for key, extra in (overrides or {}).items():
            getattr(self, key).update(extra)
        self.limits = lookup.limits(cell_name)
        self.dev = torch.device(device)
        self.task = lookup.module("tasks", self.traffic["task"])
        self.ctx = self.task.Context(self.config, self.traffic, self.dev)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def warm_up(self, seed):
        """A short fit at the cell's shapes: builds or loads the kernel
        libraries and warms every shape the window uses."""
        self.task.fit(self.ctx, window.fit_seed(seed, -1),
                      Probe(self.dev, capture=False),
                      niters=self.traffic["warmup_epochs"])
        self.sync()

    def window(self, seed, seconds, trace_on=False):
        """Whole fits back to back: another starts only while the fits so
        far predict that it ends inside ``seconds``.  Returns the probe and
        the window's wall time."""
        stretch = None
        if trace_on:
            epochs = self.traffic["epochs"]
            start = min(STRETCH_FROM, epochs // 4)
            stretch = (0, start, min(STRETCH_EPOCHS, epochs // 2))
        probe = Probe(self.dev, stretch=stretch)
        t0 = time.perf_counter()
        k = 0
        while window.start_another(time.perf_counter() - t0, k, seconds):
            self.task.fit(self.ctx, window.fit_seed(seed, k), probe)
            k += 1
        wall = time.perf_counter() - t0
        probe.close()
        return probe, wall

    def reference(self, seed, precision="fp32", fault=None):
        return self.task.reference(self.ctx, seed, PRECISIONS[precision],
                                   fault=fault)

    def check(self, fits):
        """The worst of each number over the fits, against the reference."""
        per_fit = []
        for fit in fits:
            per_fit.append(check.numbers(fit, self.reference(fit["seed"])))
            gc.collect()
        return check.worst(per_fit)

    def verdict(self, fits):
        """(correct, [(name, value, limit)]) of the fits' outputs."""
        return check.judge(self.check(fits), self.limits)

    def metrics(self, probe, wall, setup_s, trace_on):
        """{name: {value, unit}} of the cell's metrics for this run, and the
        profiled stretch (or None)."""
        stretch = None
        if trace_on:
            recs = trace.records(probe.traced)
            stretch = trace.Stretch(recs, probe.traced_epochs,
                                    probe.trace_window_s,
                                    trace.program_kernels())
            if stretch.program_launches < stretch.epochs:
                raise SystemExit(
                    f"the profiler dropped device events: "
                    f"{stretch.program_launches} of the port's kernels "
                    f"recorded in {stretch.epochs} epochs, "
                    f"{stretch.launches} kernels in all")
        unprof = window.unprofiled(probe.fits, probe.stretch)
        run = types.SimpleNamespace(
            fits=probe.fits, window_s=wall, setup_s=setup_s, stretch=stretch,
            work=self.ctx.work, model_flops=self.ctx.model_flops,
            unprofiled_ms=sum(unprof) / len(unprof) if unprof else None)
        out = {}
        for entry in lookup.metrics_for(self.spec, self.cell["name"],
                                        trace_on):
            value = lookup.module("metrics", entry["name"]).read(run)
            if value is not None:
                out[entry["name"]] = {"value": value, "unit": entry["unit"]}
        return out, stretch
