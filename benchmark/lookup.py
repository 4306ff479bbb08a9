"""Finds a cell's pieces by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's configuration
and traffic mix; the rest follows from those files:

- ``configs/<config>.json``: the model as it is run (family, widths);
- ``traffic/<mix>.json``: the task, the app's preset and its numbers, sizes,
  replicas and depth;
- ``tasks/<task>.py``: how one fit of that task runs, and its reference;
- ``counts/<family or operator>.py``: the frozen FLOP and byte arithmetic;
- ``reference/<family or operator>.py``: the plain PyTorch reference;
- ``metrics/<metric>.py``: one reader per metric;
- ``limits/<cell>.json``: the limits of the cell's output check.

A later cell or metric is a new file and a new entry; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name):
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root=CHECKOUT):
    """The parsed ``BENCHMARK.json`` at ``root``."""
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(spec, name):
    """The ``workloads`` entry called ``name``."""
    for entry in spec["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[e['name'] for e in spec['workloads']]}")


def data(kind, name):
    """``<kind>/<name>.json`` under this folder."""
    return load_json(os.path.join(HERE, kind, _checked(name) + ".json"))


def config(name):
    return data("configs", name)


def traffic(name):
    return data("traffic", name)


def limits(cell_name):
    return data("limits", cell_name)


def module(kind, name):
    """The module ``<kind>/<name>.py`` under this folder, loaded once per
    process under the name ``benchmark.<kind>.<name>`` (dots in ``name``
    become underscores)."""
    key = f"benchmark.{kind}.{_checked(name).replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def metrics_for(spec, cell_name, trace):
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones untraced, the per-layer ones traced; an entry with ``workloads``
    only in the cells it lists."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]
