"""The five readers of the program's spans (``benchmark/spans.py``): on a
synthetic store and run their values, the warm-up left out, None without
spans; on a short CPU run of a cell the host-clock readers against the
fits' own preparation."""
import types

import pytest

from benchmark import lookup, spans
from benchmark.tests import short

READERS = ("apps.inputs_ms", "trainer.setup_ms", "trainer.adam_ms",
           "trainer.tracking_ms", "wrappers.stacking_ms")


def _span(sid, name, t0, t1, parent=None, device_ms=None):
    return {"name": name, "id": sid, "parent": parent, "t0": t0, "t1": t1,
            "device_ms": device_ms}


STORE = [
    # the warm-up fit, before the window
    _span(1, "apps.inputs", 0.0, 0.5),
    _span(2, "trainer.fit", 0.6, 2.0),
    _span(3, "trainer.setup", 0.6, 0.7, 2),
    # the window's first fit, [10, 20]: two profiled epochs
    _span(4, "apps.inputs", 10.0, 10.1),
    _span(5, "trainer.fit", 10.2, 19.0),
    _span(6, "trainer.setup", 10.2, 10.22, 5),
    _span(7, "trainer.epoch", 11.0, 11.1, 5, 4.0),
    _span(8, "wrappers.wire_step.step", 11.0, 11.05, 7, 3.6),
    _span(9, "kernels.wire_step.step", 11.01, 11.04, 8, 3.5),
    _span(10, "trainer.adam", 11.05, 11.07, 7, 0.05),
    _span(11, "trainer.tracking", 11.07, 11.1, 7, 0.04),
    _span(12, "trainer.epoch", 11.1, 11.2, 5, 4.1),
    _span(13, "wrappers.wire_mlp.forward", 11.1, 11.15, 12, 3.7),
    _span(14, "kernels.wire_mlp.forward", 11.11, 11.13, 13, 3.55),
    # a wrapper inside a wrapper counts once, its kernel inside both
    _span(15, "wrappers.rotsum.forward", 11.13, 11.14, 13, 0.02),
    _span(16, "kernels.rotsum.forward", 11.13, 11.14, 15, 0.01),
    _span(17, "trainer.adam", 11.15, 11.17, 12, 0.06),
    _span(18, "trainer.tracking", 11.17, 11.2, 12, 0.08),
    # the second fit, [20, 30]: its inputs in two spans (a field and its
    # measurement)
    _span(20, "apps.inputs", 20.0, 20.05),
    _span(21, "apps.inputs", 20.05, 20.15),
    _span(22, "trainer.fit", 20.2, 29.0),
    _span(23, "trainer.setup", 20.2, 20.24, 22)]


def _run(stretch_epochs=2):
    stretch = (None if stretch_epochs is None else
               types.SimpleNamespace(epochs=stretch_epochs))
    return types.SimpleNamespace(
        fits=[{"t0": 10.0, "t1": 20.0}, {"t0": 20.0, "t1": 30.0}],
        stretch=stretch)


def _read(name, run):
    return lookup.module("metrics", name).read(run)


def test_readers_on_a_synthetic_store(monkeypatch):
    monkeypatch.setattr(spans, "store", lambda: STORE)
    run = _run()
    assert _read("apps.inputs_ms", run) == pytest.approx((100 + 150) / 2)
    assert _read("trainer.setup_ms", run) == pytest.approx((20 + 40) / 2)
    assert _read("trainer.adam_ms", run) == pytest.approx(0.11 / 2)
    assert _read("trainer.tracking_ms", run) == pytest.approx(0.12 / 2)
    assert _read("wrappers.stacking_ms", run) == pytest.approx(
        (3.6 + 3.7 - 3.5 - 3.55 - 0.01) / 2)


def test_the_warm_up_is_left_out(monkeypatch):
    monkeypatch.setattr(spans, "store", lambda: STORE)
    run = _run()
    run.fits = [{"t0": 0.0, "t1": 2.0}]
    assert _read("apps.inputs_ms", run) == pytest.approx(500.0)
    run.fits = []
    assert _read("apps.inputs_ms", run) is None
    assert _read("trainer.setup_ms", run) is None


def test_none_without_spans(monkeypatch):
    monkeypatch.setattr(spans, "store", lambda: [])
    for name in READERS:
        assert _read(name, _run()) is None, name
    monkeypatch.setattr(spans, "store", lambda: STORE)
    for name in READERS[2:]:
        assert _read(name, _run(None)) is None, name
    untimed = [dict(s, device_ms=None) for s in STORE]
    monkeypatch.setattr(spans, "store", lambda: untimed)
    for name in READERS[2:]:
        assert _read(name, _run()) is None, name


def test_a_program_without_a_span_store_reads_none(monkeypatch):
    from wire_tpu_torch.train import profiling
    monkeypatch.delattr(profiling, "spans")
    assert spans.store() == []
    for name in READERS:
        assert _read(name, _run()) is None, name


def test_host_readers_on_a_short_cpu_run(monkeypatch):
    """A cell's warm-up and one window fit on the CPU: each of the fit's
    ``apps.inputs`` and ``trainer.setup`` lies in its preparation (from
    its start to its first epoch), the warm-up's not counted."""
    s = short.cell_run("wire300.denoise", monkeypatch)
    s.warm_up(11)
    probe, _ = s.window(11, 0.0)
    (fit,) = probe.fits
    run = types.SimpleNamespace(fits=probe.fits, stretch=None)
    inputs = _read("apps.inputs_ms", run)
    setup = _read("trainer.setup_ms", run)
    prep = 1e3 * (fit["t_loop0"] - fit["t0"])
    assert 0 < inputs and 0 < setup and inputs + setup < prep
    warm = [x for x in spans.store() if x["name"] == "apps.inputs"
            and x["t1"] <= fit["t0"]]
    assert warm
    for name in READERS[2:]:
        assert _read(name, run) is None, name
