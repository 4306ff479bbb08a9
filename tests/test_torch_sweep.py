"""The port's six-family sweep app (wire_tpu_torch/apps/sweep.py) against
wire_tpu's (wire_tpu/apps/sweep.py): the same families, expected-metric
and learning-rate tables, and the same model spec for every (nonlin,
task); the three sweeps run on the CPU (device="cpu", the plain path) at a
tiny size and write their artifacts; ``--seeds`` waits for the batched
fitters.  Everything compared here is exact: tables, spec fields and the
artifact files' keys."""
import os

import numpy as np
import pytest
from scipy import io

from wire_tpu.apps import sweep as JS

from wire_tpu_torch.apps import sweep as TS

SPEC_FIELDS = ("nonlin", "in_features", "out_features", "hidden_features",
               "hidden_layers", "first_omega0", "hidden_omega0", "scale",
               "pos_encode", "sidelength")


def test_families_and_tables_are_wire_tpus():
    assert TS.NONLINS == JS.NONLINS
    assert TS.EXPECTED == JS.EXPECTED
    assert TS._DENOISE_LR == JS._DENOISE_LR
    assert TS._CT_LR == JS._CT_LR
    assert TS._SISR_LR == JS._SISR_LR


@pytest.mark.parametrize("task,kw", [
    ("denoise", dict(H=256, W=256, tau=3e1)),
    ("denoise", dict(H=200, W=120, tau=1e2)),
    ("ct", dict(H=256, W=256, tau=1e2, out_features=1,
                posenc_sidelength=100)),
    ("sisr", dict(H=256, W=256, tau=1e2))])
@pytest.mark.parametrize("nonlin", JS.NONLINS)
def test_build_gives_wire_tpus_spec(nonlin, task, kw):
    want = JS._build(nonlin, task, **kw).spec
    got = TS._build(nonlin, task, **kw).spec
    for f in SPEC_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def _check_artifacts(results, results_dir, name, metric):
    for suffix in ("_info.mat", "_metrics.mat", "_table.md"):
        assert os.path.isfile(os.path.join(results_dir, name + suffix))
    info = io.loadmat(os.path.join(results_dir, f"{name}_info.mat"))
    mets = io.loadmat(os.path.join(results_dir, f"{name}_metrics.mat"))
    table = open(os.path.join(results_dir, f"{name}_table.md")).read()
    for nonlin, r in results.items():
        assert np.isfinite(r["rec"]).all()
        assert np.isfinite(r[metric]) and np.isfinite(r["Time (s)"])
        assert nonlin in info and nonlin in mets
        assert f"| {nonlin} |" in table
        got = float(mets[nonlin][0, 0][metric].ravel()[0])
        assert got == pytest.approx(r[metric], rel=1e-6)


def test_sweep_denoise_runs_on_the_cpu(tmp_path):
    out = TS.sweep_denoise(results_dir=str(tmp_path), niters=2, size=32,
                           device="cpu")
    assert list(out) == JS.NONLINS
    assert out["mfn"]["rec"].shape == (16, 16, 3)
    _check_artifacts(out, str(tmp_path), "denoise_sweep", "Best PSNR")


def test_sweep_sisr_runs_on_the_cpu(tmp_path):
    out = TS.sweep_sisr(results_dir=str(tmp_path), niters=2, size=48,
                        device="cpu")
    assert list(out) == JS.NONLINS
    assert out["mfn"]["rec"].shape == (16, 16, 3)
    _check_artifacts(out, str(tmp_path), "sisr_sweep", "Best MSE")


def test_sweep_ct_runs_on_the_cpu(tmp_path):
    out = TS.sweep_ct(results_dir=str(tmp_path), niters=2, size=24,
                      nmeas=8, device="cpu")
    assert list(out) == JS.NONLINS
    assert out["mfn"]["rec"].shape == (24, 24)
    _check_artifacts(out, str(tmp_path), "ct_sweep", "Best PSNR")


def test_main_runs_a_family_and_refuses_seeds(tmp_path):
    img = str(tmp_path / "img.npy")
    np.save(img, np.random.default_rng(0).uniform(
        0, 1, (32, 32, 3)).astype(np.float32))
    TS.main(["denoise", "--nonlins", "mfn", "relu", "--niters", "1",
             "--image", img, "--results_dir", str(tmp_path / "r"),
             "--device", "cpu"])
    mets = io.loadmat(str(tmp_path / "r" / "denoise_sweep_metrics.mat"))
    assert "mfn" in mets and "relu" in mets and "wire" not in mets
    with pytest.raises(NotImplementedError, match="A.8"):
        TS.main(["denoise", "--nonlins", "mfn", "--seeds", "2",
                 "--device", "cpu"])


def test_default_device_is_the_card():
    """With no CUDA device the sweeps raise instead of running on the
    CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.sweep_denoise(niters=1, size=32, nonlins=["mfn"])
