"""No module the benchmark runs has ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``wire_tpu`` as its top-level name (the part before the first
dot, compared whole: ``wire_tpu_torch`` begins with ``wire_tpu``)."""
import json
import os
import subprocess
import sys
import types

from benchmark import lookup

RUN = os.path.join(lookup.CHECKOUT, "benchmark", "run.py")


def _load_run():
    import importlib.util
    spec = importlib.util.spec_from_file_location("benchmark_run_main", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    run = _load_run()
    for name in list(sys.modules):
        if name.split(".", 1)[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "wire_tpu_torch_fake.x",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("j"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "wire_tpu.apps", types.ModuleType("a"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "wire_tpu.apps"]


def test_a_whole_cpu_run_loads_no_jax():
    """A child process loads run.py and every piece each cell names, runs
    a short run of two cells on the CPU, and lists its modules."""
    code = f"""
import json, sys, runpy
runpy.run_path({RUN!r}, run_name="benchmark_run")
import pytest
from benchmark import lookup
from benchmark.tests import short
spec = lookup.benchmark_spec()
for cell in spec["workloads"]:
    tr = lookup.traffic(cell["traffic"])
    cfg = lookup.config(cell["config"])
    lookup.module("tasks", tr["task"])
    lookup.module("reference", cfg["family"])
    lookup.module("counts", cfg["family"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        lookup.module("metrics", m["name"])
mp = pytest.MonkeyPatch()
for cell in ("wire300.ct", "wire300.denoise_seeds4"):
    correct, rows = short.run(short.cell_run(cell, mp), 5)
    assert correct, rows
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=lookup.CHECKOUT,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "wire_tpu_torch" in tops and "benchmark" in tops
    assert not tops & {"jax", "jaxlib", "flax", "wire_tpu"}
