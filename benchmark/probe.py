"""The harness's own spans around the calls into the port's layers.

Nothing in ``wire_tpu_torch`` is edited: the probe replaces a method on the
model object a fit was given (``step_grads``, ``step_grads_many``, or
``apply`` for an operator fit, each called once an epoch, an operator fit's
render coming before its operator).  At every call it records an epoch
boundary: a CUDA event on the current stream (the host clock on the CPU)
and, at the first call, the host time.  ``loop_done`` closes the last
epoch when the fitter returns.  For the output check it keeps copies of the parameters
the first and the fourth call see (the init, and the state after three
Adam steps) and the gradient of the first step as the optimizer gets it.

A traced run profiles ``stretch = (fit, first epoch, epochs)``: the device
is drained, ``torch.profiler`` starts at that epoch's boundary and stops,
after another drain, at the boundary ``epochs`` later.
"""
from __future__ import annotations

import time

import torch

from benchmark import window

CAPTURE_CALLS = (0, 3)


def flatten(tree, prefix=""):
    """{path: tensor} of a nested dict/list parameter tree, paths joined
    with '/'."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _copy(tree):
    return {k: v.detach().clone() for k, v in flatten(tree).items()}


class Probe:
    def __init__(self, device, capture=True, stretch=None):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.capture = capture
        self.stretch = stretch
        self.fits = []
        self.prof = None
        self.traced = None
        self.trace_window_s = None
        self.traced_epochs = 0
        self._cur = None
        self._t_trace = None

    # -- one fit ------------------------------------------------------------
    def begin(self, seed):
        self._cur = {"seed": seed, "t0": time.perf_counter(),
                     "t_loop0": None, "marks": [], "calls": 0,
                     "p0": None, "g0": None, "p3": None}

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _boundary(self, params):
        cur = self._cur
        k = cur["calls"]
        st = self.stretch
        if st is not None and st[0] == len(self.fits):
            if k == st[1]:
                self._trace_start()
            elif k == st[1] + st[2] and self.prof is not None:
                self._trace_stop(k - st[1])
        if k == 0:
            cur["t_loop0"] = time.perf_counter()
        cur["marks"].append(self._mark())
        if self.capture and k in CAPTURE_CALLS:
            cur["p0" if k == 0 else "p3"] = _copy(params)
        cur["calls"] = k + 1

    def wrap_step(self, model, method):
        """Replace ``model.<method>`` (a step: returns (pred, grads, ...))
        by one that marks each call and keeps the first call's
        gradients."""
        real = getattr(model, method)

        def wrapped(params, *args, **kw):
            self._boundary(params)
            out = real(params, *args, **kw)
            if self.capture and self._cur["calls"] == 1:
                self._cur["g0"] = _copy(out[1])
            return out

        setattr(model, method, wrapped)

    def wrap_apply(self, model):
        """Replace ``model.apply`` (an operator fit renders once an
        iteration) by one that marks each call; at the first call a hook on
        each parameter leaf keeps the gradient autograd gives it."""
        real = model.apply

        def wrapped(params, coords):
            first = self._cur["calls"] == 0
            self._boundary(params)
            if self.capture and first:
                g0 = self._cur["g0"] = {}
                for path, leaf in flatten(params).items():
                    if leaf.requires_grad:
                        leaf.register_hook(
                            lambda g, path=path: g0.__setitem__(
                                path, g.detach().clone()))
            return real(params, coords)

        model.apply = wrapped

    def loop_done(self):
        """The fitter returned: close the last epoch."""
        if self.prof is not None:
            st = self.stretch
            self._trace_stop(self._cur["calls"] - st[1])
        self._cur["marks"].append(self._mark())
        self._cur["t_loop1"] = time.perf_counter()

    def end(self, **results):
        """The fit's results are on the host: record the fit."""
        cur = self._cur
        cur["t1"] = time.perf_counter()
        cur.update(results)
        self.fits.append(cur)
        self._cur = None
        return cur

    # -- the profiled stretch -----------------------------------------------
    def _trace_start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.dev)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t_trace = time.perf_counter()

    def _trace_stop(self, epochs):
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        self.trace_window_s = time.perf_counter() - self._t_trace
        self.prof.stop()
        self.traced_epochs = epochs
        self.stretch = (self.stretch[0], self.stretch[1], epochs)
        self.traced, self.prof = self.prof, None

    # -- after the window -----------------------------------------------------
    def close(self):
        """Epoch intervals (ms) of every fit, from its boundaries."""
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        for fit in self.fits:
            marks = fit.pop("marks")
            if self.cuda:
                ms = [marks[0].elapsed_time(m) for m in marks]
            else:
                ms = [1e3 * (m - marks[0]) for m in marks]
            fit["intervals_ms"] = window.intervals(ms)
        return self.fits
