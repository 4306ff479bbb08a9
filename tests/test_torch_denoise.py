"""The port's denoise app (wire_tpu_torch/apps/denoise.py) on the CPU with
a tiny WIRE preset: it fits, and writes info.mat, metrics.mat,
metrics_table.md and Output_img.png; an input that is neither a .npy array
nor a PNG is refused."""
import os

import numpy as np
import pytest
from scipy import io

from wire_tpu.signals import image as JI
from wire_tpu_torch.train import presets


@pytest.fixture
def tiny_wire_preset():
    presets.ENTRIES["testtinywire"] = dict(
        nonlin="wire", scale=8.0, scale_tensor=(0.0,),
        scaled_hidden_features=0, learning_rate=5e-3, hidden_features=32,
        niters=40, omega0=7.0)
    yield "testtinywire"
    presets.ENTRIES.pop("testtinywire", None)


def test_denoise_app_writes_artifacts(tiny_wire_preset, tmp_path):
    from wire_tpu_torch.apps import denoise
    img = str(tmp_path / "img.npy")
    np.save(img, JI.synthetic_image(64, 64, 3, seed=0))
    out = denoise.run(tiny_wire_preset, image=img,
                      results_dir=str(tmp_path / "res"), device="cpu")
    assert np.isfinite(out["psnr"]) and out["psnr"] > 12.0
    res = out["result"]
    assert res.best_rec.shape == (32 * 32, 3)
    assert res.mse_gt.shape == (40,) and res.best_mse <= res.mse_gt[0]
    p = out["path"]
    assert p.startswith(str(tmp_path / "res" / "denoise" / "T30.0_SNR2"))
    for f in ("info.mat", "metrics.mat", "metrics_table.md",
              "Output_img.png"):
        assert os.path.exists(os.path.join(p, f)), f
    folder = os.path.basename(p)
    info = io.loadmat(os.path.join(p, "info.mat"))[folder][0, 0]
    assert info["rec"].shape == (32, 32, 3)
    table = open(os.path.join(p, "metrics_table.md")).read().splitlines()
    assert table[0].startswith("| | Scale | Scale tensor | Tau")
    assert table[2].startswith(f"| {folder} | 8.000 | 0.000 | 30.000 |")
    assert f"{out['psnr']:.3f}" in table[2]


def test_denoise_cli_rejects_non_npy_image(tiny_wire_preset, tmp_path):
    """A file that is neither a .npy array nor a PNG (here a JPEG header
    under a .png name) is refused, naming what the port reads."""
    from wire_tpu_torch.apps import denoise
    bad = str(tmp_path / "x.png")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0\x00\x10JFIF")
    with pytest.raises(ValueError, match="PNG images and .npy arrays"):
        denoise.main(["--config_name", tiny_wire_preset, "--image", bad,
                      "--device", "cpu"])
