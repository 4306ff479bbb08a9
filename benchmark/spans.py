"""The program's own spans (``wire_tpu_torch.train.profiling``) as the
per-layer readers take them, in the run's process.  Every reader returns
None where the store holds none of its spans: a program that has no span
store, an untraced run (the hot spans are recorded only while the profiler
records), the CPU (no device time)."""
from __future__ import annotations


def store():
    """The spans the run's process recorded ([] where the program keeps
    none)."""
    try:
        from wire_tpu_torch.train import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def per_fit_ms(run, name):
    """The mean over the window's fits of the host ms of the spans called
    ``name`` that lie within each fit (its ``t0``..``t1`` on the harness's
    clock, which leaves the warm-up out), summed within a fit; None where
    no fit holds one."""
    spans = [s for s in store() if s["name"] == name]
    per = []
    for fit in run.fits:
        ms = [1e3 * (s["t1"] - s["t0"]) for s in spans
              if fit["t0"] <= s["t0"] and s["t1"] <= fit["t1"]]
        if ms:
            per.append(sum(ms))
    return sum(per) / len(per) if per else None


def timed(run):
    """The spans of the profiled stretch that carry device ms (None
    without a stretch)."""
    if run.stretch is None:
        return None
    return [s for s in store() if s["device_ms"] is not None]


def stretch_ms(run, name):
    """Device ms an epoch of the profiled stretch's spans called
    ``name``."""
    spans = timed(run)
    ms = [s["device_ms"] for s in spans or () if s["name"] == name]
    return sum(ms) / run.stretch.epochs if ms else None


def own_ms(run, outer, inner):
    """Device ms an epoch of the stretch's spans named ``outer.*`` (those
    inside no other such span) less that of the ``inner.*`` spans inside
    them: the outer layer's own device time."""
    spans = timed(run)
    if not spans:
        return None
    by_id = {s["id"]: s for s in spans}

    def around(s):
        """The nearest ``outer.*`` span around ``s``, or None."""
        p = by_id.get(s["parent"])
        while p is not None and not p["name"].startswith(outer + "."):
            p = by_id.get(p["parent"])
        return p

    tops = [s["device_ms"] for s in spans
            if s["name"].startswith(outer + ".") and around(s) is None]
    if not tops:
        return None
    inside = [s["device_ms"] for s in spans
              if s["name"].startswith(inner + ".") and around(s) is not None]
    return (sum(tops) - sum(inside)) / run.stretch.epochs
