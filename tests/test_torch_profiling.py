"""The port's spans and counters (``wire_tpu_torch/train/profiling.py``) on
the CPU: hot spans only under a profiler, as plain host ranges of the
profile and with no CUDA event otherwise; their nesting in a fit, whose
step runs ``wire_step``'s launch path through a library that runs nothing
(``fake_card_step``); the fit-level spans always; the bounded store; the
launch and build counters.  The card test (device ms, no span on the
device timeline) is ``test_hot_spans_carry_device_ms`` in
``test_torch_gpu.py``."""
import sys
import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wire_tpu_torch.apps import denoise
from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.ops import build
from wire_tpu_torch.ops import line_sample as LS
from wire_tpu_torch.ops import rotsum as R
from wire_tpu_torch.ops import wire_step as WS
from wire_tpu_torch.signals import coords as C, image as I
from wire_tpu_torch.train import profiling as P
from wire_tpu_torch.train import trainer as T
from wire_tpu_torch.train.presets import get_config

EPOCHS = 3
HOT = ("trainer.epoch", "trainer.adam", "trainer.tracking",
       "wrappers.wire_step.step", "kernels.wire_step.step")


class _FakeStepLib:
    """wire_step's library as ``_launch`` calls it, launching nothing."""

    def wire_step_max_out(self):
        return 8

    def wire_step_part_floats(self, n, d, h, o):
        return 1

    def wire_step_run(self, *args):
        return 0

    def wire_step_error_string(self, rc):
        return b"none"


def _no_stream(*args):
    return types.SimpleNamespace(cuda_stream=0)


@pytest.fixture
def fake_card_step(monkeypatch):
    """Each step of a CPU fit takes wire_step's card path (``_launch``,
    its checks, stacking, buffers and launch through ``_FakeStepLib``),
    then returns the plain step's results."""
    monkeypatch.setattr(WS, "_lib", _FakeStepLib)
    monkeypatch.setattr(torch.cuda, "current_stream", _no_stream)

    def step(params, coords, target, spec, *, nvalid=None, denom=None,
             gt=None, want_metrics=False, scratch=None):
        WS._launch(params, coords, target, spec, nvalid, denom, gt,
                   want_metrics, scratch)
        return WS.wire_step_plain(params, coords, target, spec,
                                  nvalid=nvalid, denom=denom, gt=gt,
                                  want_metrics=want_metrics)
    monkeypatch.setattr(WS, "wire_step", step)


@pytest.fixture
def store():
    P.clear()
    yield
    P.clear()


def _fit(niters=EPOCHS):
    im = I.synthetic_image(8, 8, 3, seed=0)
    model = get_inr("wire", out_features=3, hidden_features=8,
                    hidden_layers=2)
    params = model.init(torch.Generator().manual_seed(0))
    return T.fit_pointwise(model, params, C.grid2d(8, 8), im.reshape(-1, 3),
                           T.FitConfig(niters=niters), gt=im.reshape(-1, 3),
                           device="cpu")


class _Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("created with no profiler recording")


class _FakeEvent:
    """A CUDA event on the host clock (ms)."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = 1e3 * time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_no_profiler_records_no_hot_span_and_no_event(monkeypatch, store,
                                                      fake_card_step):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Refused)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Refused)
    before = P.launches("wire_step")["step"]
    res = _fit()
    assert res.mse_gt.shape == (EPOCHS,)
    assert P.launches("wire_step")["step"] == before + EPOCHS
    assert sorted(s["name"] for s in P.spans()) == ["trainer.fit",
                                                     "trainer.setup"]


def test_profiled_fit_nests_its_spans(monkeypatch, store, fake_card_step):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        _fit()
    finally:
        prof.stop()
    spans = P.spans()
    by_id = {s["id"]: s for s in spans}

    def parent(s):
        return by_id[s["parent"]]["name"]

    names = [s["name"] for s in spans]
    for name in HOT:
        assert names.count(name) == EPOCHS, (name, names)
    for s in spans:
        if s["name"] == "kernels.wire_step.step":
            assert parent(s) == "wrappers.wire_step.step"
        elif s["name"] in ("wrappers.wire_step.step", "trainer.adam",
                           "trainer.tracking"):
            assert parent(s) == "trainer.epoch"
        elif s["name"] in ("trainer.epoch", "trainer.setup"):
            assert parent(s) == "trainer.fit"
        else:
            assert s["name"] == "trainer.fit" and s["parent"] is None
        assert s["t0"] <= s["t1"]
        assert by_id.get(s["parent"], {"t0": 0})["t0"] <= s["t0"]
        # the fake events time hot spans on the host clock
        assert (s["device_ms"] is not None) == s["name"].startswith(P.HOT)
    setup = names.index("trainer.setup")
    first = min(s["t0"] for s in spans if s["name"] == "trainer.epoch")
    assert spans[setup]["t1"] <= first
    ranges = {(e.name, e.device_type, e.is_user_annotation)
              for e in prof.events() if e.name in HOT}
    assert ranges == {(name, torch.autograd.DeviceType.CPU, False)
                      for name in HOT}


def test_hot_span_open_when_the_profiler_stops_is_dropped(store):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with P.span("trainer.adam"):
            pass
        with P.span("trainer.epoch"):
            prof.stop()
    finally:
        if torch._C._autograd._profiler_enabled():
            prof.stop()
    assert [s["name"] for s in P.spans()] == ["trainer.adam"]
    with P.span("trainer.epoch") as off:
        assert off is None
    assert len(P.spans()) == 1


def test_fit_level_spans_without_a_profiler(store):
    denoise.denoise_images(get_config("WIRE_s8_o7_LR5e3_E2000"), None, 3)
    res = _fit(niters=2)
    spans = P.spans()
    assert [s["name"] for s in spans] == ["apps.inputs", "trainer.setup",
                                          "trainer.fit"]
    inputs, setup, fit = spans
    assert inputs["parent"] is None and fit["parent"] is None
    assert setup["parent"] == fit["id"]
    assert inputs["t1"] <= fit["t0"] <= setup["t0"] <= setup["t1"] <= fit[
        "t1"]
    assert all(s["device_ms"] is None for s in spans)
    assert res.mse_gt.shape == (2,)


def test_a_thread_with_no_span_open_takes_the_main_threads(store):
    got = []
    with P.span("trainer.fit") as fit:
        worker = threading.Thread(
            target=lambda: got.append(P.span("build.load").__enter__()))
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive() and got[0].parent == fit.id


def test_the_store_keeps_the_newest_spans(store):
    for k in range(P.STORE_SPANS + 10):
        with P.span("apps.inputs", k=k):
            pass
    spans = P.spans()
    assert len(spans) == P.STORE_SPANS
    assert spans[0]["args"] == {"k": 10}
    assert spans[-1]["args"] == {"k": P.STORE_SPANS + 9}


def test_trace_writes_spans_json(tmp_path, store):
    import json
    with P.trace(str(tmp_path / "tr")):
        with P.span("trainer.tracking"):
            torch.ones(4).sum()
    with open(tmp_path / "tr" / "spans.json") as f:
        out = json.load(f)
    assert [s["name"] for s in out["spans"]] == ["trainer.tracking"]
    assert out["counters"] == P.counters()


# the old module dicts' keys: every module's directions, registered at 0
DIRECTIONS = {"wire_step": ["step"], "wire_mlp": ["backward", "forward"],
              "real_mlp": ["backward", "forward", "step"],
              "wire2d": ["backward", "forward", "step"],
              "mfn": ["backward", "forward", "step"],
              "mscale2_step": ["step"], "rotsum": ["adjoint", "forward"],
              "line_sample": ["gather", "scatter"]}


@pytest.mark.parametrize("module", sorted(DIRECTIONS))
def test_every_module_counts_its_directions(module):
    """Read before any launch (``launches`` imports the module, which
    registers each direction at 0), as the old module dicts were."""
    assert sorted(P.launches(module)) == DIRECTIONS[module]


class _FakeLib:
    """A library whose every function returns 0."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_launch_counters_advance_one_a_launch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", _no_stream)
    monkeypatch.setattr(R, "_lib", _FakeLib)
    monkeypatch.setattr(LS, "_lib", _FakeLib)
    t = torch.zeros(4)
    before = P.counters()
    R._run("forward", t, t, t, 1, 2, 2)
    R._run("adjoint", t, t, t, 1, 2, 2)
    R._run("adjoint", t, t, t, 1, 2, 2)
    LS._run("spectrum_gather", "gather", (t,), 1, 1, 1, 1, "cpu")
    after = P.counters()
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {
        "launches.rotsum.forward": 1, "launches.rotsum.adjoint": 2,
        "launches.line_sample.gather": 1}


def test_counters_lose_no_update_across_threads():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = P.counters().get("test.threads", 0)
        workers = [threading.Thread(target=lambda: [
            P.count("test.threads") for _ in range(2000)]) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert P.counters()["test.threads"] == before + 16 * 2000
    finally:
        sys.setswitchinterval(interval)


def test_a_cached_library_counts_no_build(monkeypatch, tmp_path, store):
    """``build`` with nvcc replaced by a stub that writes the library:
    the first call compiles (a ``build.compile`` span, one
    ``build.compiled.<name>``), the second finds it and counts nothing;
    ``load`` is a ``build.load`` span around both."""
    lib = str(tmp_path / "stub-0.so")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "library_path", lambda name: lib)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)

    def nvcc(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\0")
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")
    monkeypatch.setattr(build.subprocess, "run", nvcc)
    key = "build.compiled.stub"
    before = P.counters().get(key, 0)
    assert build.load.__wrapped__("stub") == lib
    assert P.counters()[key] == before + 1
    assert build.build("stub") == (lib, "")
    assert build.load.__wrapped__("stub") == lib
    assert P.counters()[key] == before + 1
    spans = P.spans()
    assert [(s["name"], s["args"]) for s in spans] == [
        ("build.compile", {"library": "stub"}),
        ("build.load", {"library": "stub"}),
        ("build.load", {"library": "stub"})]
    assert spans[0]["parent"] == spans[1]["id"]
