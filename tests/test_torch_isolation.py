"""The port stands alone: every module of wire_tpu_torch and chip_smoke.py
imports with jax, optax, wire_tpu, pandas, matplotlib and cv2 blocked (the
B-spline, multiscale, MFN and WIRE-2D slices' modules and the sweep app
among them), and chip_smoke.py refuses to run without a CUDA device."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("jax", "jaxlib", "optax", "wire_tpu", "pandas", "tabulate",
           "matplotlib", "cv2")

IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
import wire_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    wire_tpu_torch.__path__, "wire_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k.split(".")[0] in {BLOCKED!r} for k, v in sys.modules.items()
               if v is not None)
print(" ".join(names))
print(len(names))
"""

SLICE_MODULES = ("wire_tpu_torch.ops.real_mlp", "wire_tpu_torch.apps.sisr",
                 "wire_tpu_torch.operators.forward",
                 "wire_tpu_torch.signals.image", "wire_tpu_torch.ops.resample",
                 "wire_tpu_torch.train.metrics",
                 "wire_tpu_torch.nn.activations", "wire_tpu_torch.nn.models",
                 "wire_tpu_torch.ops.mscale2_step", "wire_tpu_torch.tree",
                 "wire_tpu_torch.bridge", "wire_tpu_torch.train.trainer",
                 "wire_tpu_torch.ops.mfn", "wire_tpu_torch.apps.sweep",
                 "wire_tpu_torch.nn.init", "wire_tpu_torch.nn.registry",
                 "wire_tpu_torch.ops.wire2d")


def test_every_module_imports_without_jax_or_wire_tpu():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25
    imported = out.stdout.split("\n")[-3].split()
    for name in SLICE_MODULES:
        assert name in imported, name


def test_chip_smoke_without_cuda_exits_nonzero(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout and '"phase"' not in out.stdout
