"""A cell's run on the CPU at a size a test run holds: 16 hidden
features, fits of 4 epochs (the app's preset, or the sweep's default, cut
to that depth for the test alone), the cell's own image and rows."""
import inspect

import torch

from benchmark import lookup
from benchmark.harness import CellRun

EPOCHS = 4
HIDDEN = 16
# every cell the benchmark has files for (configuration, traffic, limits);
# those BENCHMARK.json does not list yet are added to the tests' spec
CELLS = {"wire300.denoise": ("wire300", "denoise_wire_s8_o7"),
         "bspline256.denoise": ("bspline256", "denoise_bspline_s9_5"),
         "wire300.ct": ("wire300", "ct_wire_s12_o8"),
         "wire300.denoise_seeds4": ("wire300", "sweep_denoise_wire_seeds4")}


def spec():
    """BENCHMARK.json with every cell of ``CELLS``."""
    out = lookup.benchmark_spec()
    listed = {c["name"] for c in out["workloads"]}
    extra = [{"name": name, "config": cfg, "traffic": tr, "chips": 1}
             for name, (cfg, tr) in CELLS.items() if name not in listed]
    return dict(out, workloads=out["workloads"] + extra)


def cell_run(cell, monkeypatch):
    from wire_tpu_torch.apps import sweep
    from wire_tpu_torch.train import presets
    torch.set_num_threads(2)
    full = spec()
    traffic = lookup.traffic(lookup.cell(full, cell)["traffic"])
    over = {"epochs": EPOCHS, "warmup_epochs": 1}
    if "preset" in traffic:
        short = f"{traffic['preset']}_test{EPOCHS}"
        monkeypatch.setitem(presets.ENTRIES, short, dict(
            presets.ENTRIES[traffic["preset"]], niters=EPOCHS))
        over["preset"] = short
    else:
        fn = sweep.sweep_denoise_seeds
        names = [k for k, v in inspect.signature(fn).parameters.items()
                 if v.default is not inspect.Parameter.empty]
        defaults = list(fn.__defaults__)
        defaults[names.index("niters")] = EPOCHS
        monkeypatch.setattr(fn, "__defaults__", tuple(defaults))
    return CellRun(full, cell, "cpu", overrides={
        "config": {"hidden_features": HIDDEN}, "traffic": over})


def run(s, seed):
    """What ``run.py`` does after its look for a card: the warm-up, a
    window of one fit, the verdict."""
    s.warm_up(seed)
    probe, _ = s.window(seed, 0.0)
    return s.verdict(probe.fits)
